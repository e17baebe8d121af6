"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and what the entry points import."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_node=600, n_edge=3000, n_feat=16, n_hidden=32, n_class=5)
# a synthetic stand-in just large enough for the Planetoid-style split
ARGS = ("--dataset=", "--N_nodes=2000", "--num_feats=16", "--num_classes=4",
        "--whetherHasSE=100")


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_phase_spmm_small(cs):
    errs = cs.phase_spmm(600, 3000, widths=(16, 5))
    assert {"gather_fwd_d16", "gather_t_d5", "bf16_operands_fwd_d16",
            "bf16_operands_t_d5"} <= set(errs)


def test_phase_teacher_small(cs):
    out = cs.phase_teacher(epochs=4, args=ARGS)
    assert float(out["loss_last"]) < float(out["loss_first"])


def test_phase_gpu_vs_cpu_small(cs):
    out = cs.phase_gpu_vs_cpu(SMALL, steps=2)
    assert len(out["loss_gap_highest"]) == len(out["grad_gap_highest"]) == 2


def test_phase_semlp_small(cs):
    out = cs.phase_semlp(epochs=2, args=ARGS)
    assert np.isfinite(float(out["part2_loss_last"]))


def test_phase_linkpred_small(cs):
    out = cs.phase_linkpred(2000, 8000, 16, steps=2, batch_size=512,
                            eval_pos=64)
    assert out["steps"] == 2 and out["msg_edges"] > 0


def test_phase_multidevice_on_four_cpu_devices(cs):
    out = cs.phase_multidevice(4, SMALL, epochs=2, args=ARGS)
    assert out["n_devices"] == 4
    assert len(out["loss_gap"]) == len(out["grad_gap"]) == 3


def _run(code_or_args, env_extra=None, cwd=ROOT):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_and_prints_no_verdict():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.parametrize("module", ["main", "chip_smoke", "bench",
                                    "bench_linkpred"])
def test_entry_points_load_no_heavy_libraries(module):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {module}; "
            "import json; print(json.dumps(sorted(m for m in "
            "('flax', 'orbax', 'torch', 'matplotlib') if m in sys.modules)))")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


_CACHE_CODE = ("import jax, gnn_tail_generalization as p; "
               "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_defaults_inside_checkout():
    import gnn_tail_generalization as pkg

    r = _run(["-c", _CACHE_CODE])
    assert r.returncode == 0, r.stderr
    path = r.stdout.strip().splitlines()[-1]
    assert path == pkg.DEFAULT_COMPILE_CACHE_DIR
    assert os.path.dirname(path) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


def test_compile_cache_env_var_wins(tmp_path):
    r = _run(["-c", _CACHE_CODE],
             {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_compile_cache_rule(monkeypatch):
    import gnn_tail_generalization as pkg

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("GNN_NO_COMPILE_CACHE", raising=False)
    assert pkg.compile_cache_dir() == pkg.DEFAULT_COMPILE_CACHE_DIR
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert pkg.compile_cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    monkeypatch.setenv("GNN_NO_COMPILE_CACHE", "1")
    assert pkg.compile_cache_dir() is None
