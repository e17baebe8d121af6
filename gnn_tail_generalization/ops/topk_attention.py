"""Batched latent-neighbor discovery (the Cold Brew "replacement" op).

The reference loops over every node in Python, doing a (1 x se_dim) @
(se_dim x N) matvec, argsort, top-K softmax and a tiny matmul per node
(``/root/reference/MLP_model/__init__.py:143-156``) — its #2 hot spot.

Batched formulation: ONE [B, se_dim] x [se_dim, N] matmul for all
scores, ``jax.lax.top_k`` for neighbor selection, masked softmax over the K
selected scores, and a batched gather-weighted-sum — the Python loop
collapses into four fused XLA ops.

Semantics preserved exactly: softmax over the top-K *raw* scores, weighted
sum of the corresponding teacher-SE rows, all detached from the gradient
tape (the caller stops gradients).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def latent_neighbor_replace(
    le_guess: jax.Array,  # [B, se_dim] student's guessed embedding
    teacher_se: jax.Array,  # [N, se_dim] teacher embedding table
    top_k: int,
    precision=jax.lax.Precision.HIGHEST,
    row_chunk: int = 8192,
    score_dtype=None,
) -> jax.Array:
    """Virtual-neighborhood embedding per batch row (MLP_model/__init__.py:143-156).

    Returns [B, se_dim]: softmax(top-K of le_guess @ SE^T) @ SE[selected].

    The [B, N] score matrix is never fully materialized: rows are processed
    in ``row_chunk`` blocks under lax.map, so arxiv-scale batches
    (90k x 169k scores = 61 GB dense) stay within a ~169k x 8k working set.

    ``score_dtype=jnp.bfloat16`` runs the [B,N] scoring matmul (the 90+%
    FLOP term: ~17 TFLOP at arxiv scale) with bf16 operands and f32
    accumulation; selection/softmax/weighted-sum stay f32. Ranking by f32-accumulated scores is robust to the operand cast;
    defaults to the reference-faithful full-precision path."""
    b = le_guess.shape[0]

    def block(rows):
        if score_dtype is not None:
            scores = jnp.matmul(rows.astype(score_dtype),
                                teacher_se.T.astype(score_dtype),
                                preferred_element_type=jnp.float32)
        else:
            scores = jnp.matmul(rows, teacher_se.T, precision=precision)
        top_scores, top_idx = jax.lax.top_k(scores, top_k)
        attn = jax.nn.softmax(top_scores, axis=-1)
        neigh = teacher_se[top_idx]
        return jnp.einsum("bk,bkd->bd", attn, neigh, precision=precision)

    if b <= row_chunk:
        return block(le_guess)
    pad = (-b) % row_chunk
    padded = jnp.pad(le_guess, ((0, pad), (0, 0)))
    chunks = padded.reshape(-1, row_chunk, le_guess.shape[1])
    out = jax.lax.map(block, chunks)
    return out.reshape(-1, teacher_se.shape[1])[:b]


def make_dist_latent_replace(mesh, axis: str, rows_per_shard: int,
                             n_valid: int,
                             precision=jax.lax.Precision.HIGHEST):
    """Sharded latent-neighbor discovery over a row-sharded SE table.

    Returns ``fn(le_guess, teacher_se, top_k)`` with the same semantics as
    :func:`latent_neighbor_replace` where ``teacher_se`` is
    [n_node_pad, se_dim] row-sharded over the mesh's ``axis`` and
    ``le_guess`` is a replicated batch. Per shard: local [B, rows] scores
    -> local top-k (GLOBAL candidate ids) -> all_gather of S*K candidates
    -> exact global top-k -> softmax -> each shard contributes its owned
    SE rows to the weighted sum, merged with ONE [B, se_dim] psum (the
    'psum-of-partial-topk' plan, VERDICT r3 item 3). Rows >= ``n_valid``
    (mesh padding — their SE entries are biases-of-zero-features, not
    real nodes) are masked to -inf before selection.

    Exactness vs the single-device op: scores are computed whole within
    one shard (the table is row-sharded), so values are identical; ties
    BETWEEN equal scores may select a different (equally-scored) neighbor
    when the tie straddles a shard's local top-k cut — measure-zero for
    real-valued embeddings."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def fn(le_guess, teacher_se, top_k: int):
        @partial(
            shard_map, mesh=mesh, in_specs=(P(), P(axis, None)),
            out_specs=P(), check_vma=False,
        )
        def run(le, se_local):
            k = jax.lax.axis_index(axis)
            row0 = k * rows_per_shard
            scores = jnp.matmul(le, se_local.T, precision=precision)
            cols = row0 + jax.lax.broadcasted_iota(
                jnp.int32, scores.shape, 1)
            scores = jnp.where(cols < n_valid, scores, -jnp.inf)
            v, i = jax.lax.top_k(scores, top_k)  # local [B, K]
            gi = i + row0
            # shard-major candidate list keeps global-index tie order
            av = jax.lax.all_gather(v, axis)  # [S, B, K]
            ai = jax.lax.all_gather(gi, axis)
            s = av.shape[0]
            b = le.shape[0]
            av = jnp.transpose(av, (1, 0, 2)).reshape(b, s * top_k)
            ai = jnp.transpose(ai, (1, 0, 2)).reshape(b, s * top_k)
            v2, pos = jax.lax.top_k(av, top_k)  # global [B, K]
            sel = jnp.take_along_axis(ai, pos, axis=1)
            attn = jax.nn.softmax(v2, axis=-1)
            # local contribution of the weighted sum; ONE psum merges
            local = sel - row0
            ok = (local >= 0) & (local < rows_per_shard)
            safe = jnp.clip(local, 0, rows_per_shard - 1)
            neigh = jnp.where(ok[:, :, None], se_local[safe], 0.0)
            out = jnp.einsum("bk,bkd->bd", attn, neigh,
                             precision=precision)
            return jax.lax.psum(out, axis)

        return run(le_guess, teacher_se)

    return fn
