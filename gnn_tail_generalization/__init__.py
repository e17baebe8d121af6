"""Cold Brew (amazon-science/gnn-tail-generalization, ICLR 2022) in JAX.

JAX/XLA for the compute graph, a gather + ``segment_sum`` SpMM for the
sparse hot op, ``jax.sharding`` + ``shard_map`` for multi-device scale-out.

Layer map (mirrors SURVEY.md section 7):

- ``graph/``       immutable static-shape graph container + host-side builders
- ``ops/``         SpMM / SDDMM / top-k attention (dense-matmul and gather
                   paths) with custom VJPs
- ``nn/``          modules (nn/module.py): GCN conv with Structural
                   Embeddings, norm / residual / graph-dropout trick zoo, MLPs
- ``models/``      TeacherGNN, SEMLP (Cold Brew student), StudentBaseMLP,
                   GraphMLP
- ``propagation/`` label propagation / Correct&Smooth / diffusion features
- ``parallel/``    device-mesh sharding of graphs and the distributed SpMM
- ``train/``       jitted train loops, eval (head/tail/isolation), checkpoints
- ``data/``        dataset registry: synthetic generators + Planetoid raw reader
- ``linkpred/``    link-prediction encoders/predictors/losses/samplers
"""
import os

__version__ = "0.1.0"

#: Where compiled programs are cached when ``JAX_COMPILATION_CACHE_DIR`` is
#: not set: a fixed directory inside the checkout (git-ignored).
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _disable_numpy_thp_madvise():
    """Turn off numpy's MADV_HUGEPAGE on large allocations.

    On hosts with ``transparent_hugepage/defrag = [madvise]``, numpy's
    hugepage madvise makes every first touch of a fresh large buffer run
    synchronous memory compaction, which slows host-side graph
    preprocessing (bucket fills, edge expansions) by orders of magnitude.
    Set GNN_KEEP_NUMPY_THP=1 to keep numpy's default."""
    if os.environ.get("GNN_KEEP_NUMPY_THP"):
        return
    try:
        try:
            from numpy._core import multiarray as _ma  # numpy >= 2
        except ImportError:  # pragma: no cover - numpy 1.x
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - private API may move
        pass


_disable_numpy_thp_madvise()


def compile_cache_dir():
    """The directory this package points JAX's persistent compilation
    cache at, or None when it leaves the choice to JAX: when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself) or when
    GNN_NO_COMPILE_CACHE=1."""
    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.environ.get("GNN_NO_COMPILE_CACHE")):
        return None
    return DEFAULT_COMPILE_CACHE_DIR


def _enable_jax_compilation_cache():
    """Persistent JAX compilation cache: a re-run of the same program loads
    it from disk instead of compiling. Programs cheaper than 1 s to compile
    skip the cache (write cost)."""
    path = compile_cache_dir()
    if path is None:
        return
    try:
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:  # pragma: no cover - config may move across versions
        pass


_enable_jax_compilation_cache()
