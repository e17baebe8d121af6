"""Multi-host scaffolding: 2 processes x 4 virtual CPU devices each.

Proves the jax.distributed.initialize code path (parallel/multihost.py)
compiles and agrees numerically: both processes join a process group,
build the SAME DistGraph via the multi-process-safe global_put, run the
ring SpMM + grad over the 8-device global mesh, and train the real
teacher for 2 epochs. The reference has no multi-node anything
(SURVEY.md section 2.9)."""
import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

addr, pid = sys.argv[1], int(sys.argv[2])
from gnn_tail_generalization.parallel import multihost as mh

mh.initialize_multihost(coordinator_address=addr, num_processes=2,
                        process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert len(jax.local_devices()) == 4

import jax.numpy as jnp
from gnn_tail_generalization.parallel import distgraph as dgm
from gnn_tail_generalization.ops.spmm import spmm

mesh = mh.make_multihost_graph_mesh()
# host-major ordering: first 4 mesh devices belong to process 0
assert [d.process_index for d in mesh.devices.reshape(-1)] == [0]*4 + [1]*4

rng = np.random.default_rng(0)  # identical data in both processes (SPMD)
n, e = 96, 500
src = rng.integers(0, n, e)
dst = rng.integers(0, n, e)
w = rng.normal(size=e).astype(np.float32)
dense = np.zeros((n, n), np.float32)
np.add.at(dense, (dst, src), w)

dg = dgm.build_dist_graph(np.stack([src, dst]), n, mesh, edge_weight=w,
                          rb=8)
npad = dg.n_node_pad
sh = jax.sharding.NamedSharding(
    mesh, jax.sharding.PartitionSpec("graph", None))
x = rng.normal(size=(n, 32)).astype(np.float32)
xg = dgm.global_put(dgm.pad_rows_np(x, npad), sh)
ct = rng.normal(size=(n, 32)).astype(np.float32)
ctg = dgm.global_put(dgm.pad_rows_np(ct, npad), sh)

y = jax.jit(lambda dg, x: spmm(dg, x))(dg, xg)
dx = jax.jit(jax.grad(lambda x, dg, ct: jnp.vdot(spmm(dg, x), ct)))(
    xg, dg, ctg)

from jax.experimental import multihost_utils
y_host = multihost_utils.process_allgather(y, tiled=True)[:n]
dx_host = multihost_utils.process_allgather(dx, tiled=True)[:n]
err_y = float(np.abs(y_host - dense @ x).max())
err_dx = float(np.abs(dx_host - dense.T @ ct).max())
assert err_y < 1e-3 and err_dx < 1e-3, (err_y, err_dx)

# 2-epoch real-teacher training across the two hosts
import dataclasses
from gnn_tail_generalization.config import (
    apply_arch_configs, build_config,
)
from gnn_tail_generalization.data.datasets import (
    NodeData, prepare_sharded,
)
from gnn_tail_generalization.data.synthetic import (
    synthetic_features_labels,
)
from gnn_tail_generalization.train import loops

cfg = build_config(dataset="Cora", train_which="TeacherGNN",
                   whetherHasSE="100", se_reg=0.5)
cfg = dataclasses.replace(cfg, N_nodes=n, num_feats=24, num_classes=5,
                          dim_hidden=16, dropout=0.0)
cfg = apply_arch_configs(cfg)
xf, yf = synthetic_features_labels(n, 24, 5, 0)
train = np.zeros(n, bool); train[:48] = True
data = NodeData(x=xf, y=yf, edge_index=np.stack([src, dst]),
                train_mask=train, val_mask=None, test_mask=~train,
                name="mh-test")
pd = prepare_sharded(data, cfg, mesh, rb=8)
res = loops.train_teacher(cfg, pd, seed=0, epochs=2)
assert np.isfinite(res.records).all()

# sharded checkpoint across the process group: each process writes only
# its addressable shards, restore reassembles the global arrays
from gnn_tail_generalization.train.checkpoint import (
    load_sharded_state, save_sharded_state,
)

ckpt_dir = sys.argv[3]
state = {"params": res.variables["params"], "epoch": 2}
save_sharded_state(ckpt_dir, state)
restored = load_sharded_state(ckpt_dir, state)
assert restored["epoch"] == 2
for a, b in zip(jax.tree.leaves(state["params"]),
                jax.tree.leaves(restored["params"])):
    ah = multihost_utils.process_allgather(a, tiled=True)
    bh = multihost_utils.process_allgather(b, tiled=True)
    assert np.array_equal(ah, bh)
print("MULTIHOST_OK", pid, err_y, err_dx, res.records[-1, 1], flush=True)
"""


@pytest.mark.slow
def test_two_process_group(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    addr = f"localhost:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.setdefault("PYTHONPATH", "")
    env["PYTHONPATH"] = f"/root/repo:{env['PYTHONPATH']}"

    ckpt_dir = str(tmp_path / "mh_ckpt")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), addr, str(pid), ckpt_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-3000:]
