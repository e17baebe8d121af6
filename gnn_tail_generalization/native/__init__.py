"""ctypes bindings for the native host-side graph-prep library.

Auto-builds ``libgraph_prep.so`` with g++ on first import when missing
(zero-dependency: no pybind11/cmake needed for this single TU). All entry
points have pure-numpy fallbacks in their callers; ``AVAILABLE`` reports
whether the native path is active.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libgraph_prep.so")
_SRC = os.path.join(_DIR, "graph_prep.cpp")

_lib = None
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", _SO],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def _load():
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None  # cache failures: don't re-run g++ per call
    if not os.path.exists(_SO) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
    ):
        if not _build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _load_failed = True
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c64 = ctypes.c_int64

    lib.ring_max_bucket.argtypes = [i64p, i64p, c64, c64, c64]
    lib.ring_max_bucket.restype = c64
    lib.ring_buckets.argtypes = [
        i64p, i64p, f32p, c64, c64, c64, c64, i32p, i32p, f32p
    ]
    lib.edge_graph_num_pairs.argtypes = [i64p, i64p, c64, c64]
    lib.edge_graph_num_pairs.restype = c64
    lib.edge_graph_pairs.argtypes = [
        i64p, i64p, c64, c64, ctypes.c_uint64, i64p, i64p
    ]
    lib.edge_graph_pairs.restype = c64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def edge_graph_pair_arrays(src, dst, max_degree: int | None, seed: int):
    """Native all-pairs edge-graph expansion (linkpred/edge_lp.py):
    returns the full [2, m + n_pairs] int64 edge-graph index (m self loops
    followed by all ordered distinct scored-edge pairs sharing an
    endpoint), or None when the library is unavailable. The whole output
    is assembled in C — zero numpy copies."""
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(src, np.int64)
    d = np.ascontiguousarray(dst, np.int64)
    m = len(s)
    cap = 0 if max_degree is None else int(max_degree)
    n_pairs = int(lib.edge_graph_num_pairs(s, d, m, cap))  # upper bound
    out = np.empty((2, m + n_pairs), np.int64)
    written = int(lib.edge_graph_pairs(
        s, d, m, cap, ctypes.c_uint64(seed).value, out[0], out[1]))
    return out[:, :written]


def ring_bucket_arrays(senders, receivers, weights, rows_per_shard: int,
                       n_shards: int, pad_multiple: int = 8):
    """Native (S, S, e_bucket) double-bucketing for the ring SpMM; None
    when unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(senders, np.int64)
    r = np.ascontiguousarray(receivers, np.int64)
    w = np.ascontiguousarray(weights, np.float32)
    n_edge = len(s)
    mx = int(lib.ring_max_bucket(s, r, n_edge, rows_per_shard, n_shards))
    e_b = max(((mx + pad_multiple - 1) // pad_multiple) * pad_multiple,
              pad_multiple)
    out_s = np.zeros((n_shards, n_shards, e_b), np.int32)
    out_r = np.zeros((n_shards, n_shards, e_b), np.int32)
    out_w = np.zeros((n_shards, n_shards, e_b), np.float32)
    lib.ring_buckets(s, r, w, n_edge, rows_per_shard, n_shards, e_b,
                     out_s, out_r, out_w)
    return out_s, out_r, out_w, e_b
