"""Negative edge samplers, fixed-shape (jittable).

Reference parity: ``/root/reference/Link_prediction_model/negative_sample.py``
- global:      uniform non-edge pairs (PyG negative_sampling semantics:
  existing edges and self loops excluded), [B, num_neg, 2]
- global_perm: one batch of uniform non-edges, permuted copies
- local:       fixed source from the positive edge, random destination

Static shapes: PyG's rejection loop is replaced by fixed-rounds resampling —
draw uniform pairs, test membership against the sorted edge-key set with
searchsorted, redraw collisions a fixed number of rounds (collision
probability E/N^2 per draw makes leftovers vanishingly rare; any survivor
is kept, an O(E/N^2) approximation that keeps every shape static).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


#: multiplicative-hash constants; int32 wraparound is deliberate. A hash
#: collision only causes a valid negative to be resampled (over-rejection);
#: a real edge is always detected — exactly the safe direction here.
_H1, _H2 = np.int32(-1640531527), np.int32(97)  # 2654435761 wrapped, prime


def _hash32(src, dst):
    return src * _H1 + dst * _H2


def edge_keys(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Sorted int32 hash keys of (src, dst) pairs + self loops, for
    membership tests (the reference adds self loops before sampling,
    negative_sample.py:7,23). int64 pair keys would overflow jax's default
    int32 for N > ~46k, hence the hash."""
    e = np.asarray(edge_index, np.int64)
    with np.errstate(over="ignore"):
        keys = _hash32(e[0].astype(np.int32), e[1].astype(np.int32))
        loops = np.arange(n_node, dtype=np.int32)
        lkeys = _hash32(loops, loops)
    return np.unique(np.concatenate([keys, lkeys]))


def rejection_sample_non_edges(rng, keys_sorted: np.ndarray, n_node: int,
                               count: int) -> np.ndarray:
    """Host-side uniform non-edge sampler shared by simple_split_edges and
    the surgery edge splitter: redraw until ``count`` candidate pairs pass
    the hashed-edge-set membership and self-loop filters. Returns
    [count, 2] int64."""
    out = np.empty((count, 2), np.int64)
    filled = 0
    while filled < count:
        cand = rng.integers(0, n_node, (2, max(count * 2, 16)))
        with np.errstate(over="ignore"):
            ck = _hash32(cand[0].astype(np.int32), cand[1].astype(np.int32))
        ok = ~np.isin(ck, keys_sorted) & (cand[0] != cand[1])
        take = min(count - filled, int(ok.sum()))
        out[filled:filled + take] = cand[:, ok][:, :take].T
        filled += take
    return out


#: empty-slot sentinel for the hash-bucket membership table. A real key
#: equal to the sentinel is simply routed to the spill array at build
#: time, so the device test stays exact.
_EMPTY = np.int32(-(2**31))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["buckets", "spill"], meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Membership:
    """O(1) edge-membership structure: hashed keys bucketized into
    [n_buckets, 8] int32 rows (32 B) plus a SORTED spill array for
    overflowing buckets and sentinel-valued keys. One gather + 8 compares
    replaces searchsorted's ~25 SEQUENTIAL binary-search gathers over the
    full sorted key array."""

    buckets: jax.Array  # [n_buckets, 8] int32, _EMPTY = free
    spill: jax.Array  # [n_spill] int32 sorted


def build_membership(keys_sorted: np.ndarray,
                     slots: int = 8) -> Membership:
    """Host-side bucketize of edge_keys output (unique int32 hashes)."""
    keys = np.asarray(keys_sorted, np.int32)
    n_buckets = max(1, int(2 ** np.ceil(np.log2(max(len(keys), 2) / 2))))
    ok = keys != _EMPTY
    spill_list = [keys[~ok]]
    keys = keys[ok]
    b = keys.astype(np.uint32) & np.uint32(n_buckets - 1)
    order = np.argsort(b, kind="stable")
    bs, ks = b[order], keys[order]
    # rank within bucket
    starts = np.searchsorted(bs, np.arange(n_buckets, dtype=np.uint32))
    rank = np.arange(len(ks)) - starts[bs]
    fits = rank < slots
    table = np.full((n_buckets, slots), _EMPTY, np.int32)
    table[bs[fits], rank[fits]] = ks[fits]
    spill_list.append(ks[~fits])
    spill = np.sort(np.concatenate(spill_list)).astype(np.int32)
    if len(spill) == 0:
        spill = np.asarray([_EMPTY], np.int32)  # static nonzero shape
    return Membership(buckets=jnp.asarray(table), spill=jnp.asarray(spill))


def _is_member(keys, src: jax.Array, dst: jax.Array) -> jax.Array:
    """Membership test against ``keys``: a Membership table (one 32B-row
    gather + spill check) or the legacy sorted key array (searchsorted)."""
    cand = _hash32(src.astype(jnp.int32), dst.astype(jnp.int32))
    if isinstance(keys, Membership):
        rows = keys.buckets[
            cand.astype(jnp.uint32)
            & np.uint32(keys.buckets.shape[0] - 1)]  # [n, slots]
        hit = jnp.any(rows == cand[:, None], axis=-1)
        pos = jnp.clip(jnp.searchsorted(keys.spill, cand), 0,
                       keys.spill.shape[0] - 1)
        return hit | (keys.spill[pos] == cand)
    pos = jnp.searchsorted(keys, cand)
    pos = jnp.clip(pos, 0, keys.shape[0] - 1)
    return keys[pos] == cand


@partial(jax.jit, static_argnums=(2, 3, 4))
def global_neg_sample(rng, keys_sorted, n_node: int, num_samples: int,
                      num_neg: int, rounds: int = 3):
    """[num_samples, num_neg, 2] uniform non-edges."""
    total = num_samples * num_neg

    def draw(k):
        k1, k2 = jax.random.split(k)
        src = jax.random.randint(k1, (total,), 0, n_node)
        dst = jax.random.randint(k2, (total,), 0, n_node)
        return src, dst

    src, dst = draw(rng)
    for i in range(rounds):
        rng = jax.random.fold_in(rng, i + 1)
        bad = _is_member(keys_sorted, src, dst)
        s2, d2 = draw(rng)
        src = jnp.where(bad, s2, src)
        dst = jnp.where(bad, d2, dst)
    return jnp.stack([src, dst], axis=-1).reshape(num_samples, num_neg, 2)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def global_perm_neg_sample(rng, keys_sorted, n_node: int, num_samples: int,
                           num_neg: int, perm_within: int = 0):
    """One uniform non-edge batch + (num_neg-1) permuted copies
    (negative_sample.py:21-26,42-57). ``perm_within`` > 0 permutes within
    consecutive groups of that size (epoch-batched draws: each step's
    slice keeps the reference's permute-within-the-minibatch semantics)."""
    base = global_neg_sample(rng, keys_sorted, n_node, num_samples, 1)
    base = base[:, 0, :]  # [num_samples, 2]
    grp = perm_within if perm_within else num_samples
    assert num_samples % grp == 0, (num_samples, grp)
    n_grp = num_samples // grp
    outs = [base]
    for i in range(num_neg - 1):
        k = jax.random.fold_in(rng, 100 + i)
        # independent permutation per group (per step when epoch-batched)
        perms = jax.vmap(lambda kk: jax.random.permutation(kk, grp))(
            jax.random.split(k, n_grp))
        outs.append(jnp.take_along_axis(
            base.reshape(n_grp, grp, 2), perms[:, :, None], axis=1
        ).reshape(-1, 2))
    return jnp.stack(outs, axis=1)  # [num_samples, num_neg, 2]


@partial(jax.jit, static_argnums=(2, 3, 4))
def local_neg_sample(rng, pos_edges, n_node: int, num_neg: int,
                     random_src: bool = False):
    """Fixed src (or random endpoint), uniform dst
    (negative_sample.py:28-40)."""
    b = pos_edges.shape[0]
    if random_src:
        side = jax.random.randint(jax.random.fold_in(rng, 0), (b,), 0, 2)
        src = jnp.take_along_axis(pos_edges, side[:, None], axis=1)[:, 0]
    else:
        src = pos_edges[:, 0]
    src = jnp.repeat(src[:, None], num_neg, axis=1).reshape(-1)
    dst = jax.random.randint(
        jax.random.fold_in(rng, 1), (num_neg * b,), 0, n_node
    )
    return jnp.stack([src, dst], axis=-1).reshape(b, num_neg, 2)
