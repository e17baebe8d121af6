"""Experiment driver CLI.

Mirrors ``/root/reference/main.py`` (seed loop, per-seed trainer, stacked
result tensor) over the typed config pipeline — every reference flag of
base_options.py is accepted with the same name/default via the Config
dataclass; unknown dataset files fall back to a synthetic stand-in (this
environment never downloads).

Usage:
  python main.py --dataset=Cora --train_which=TeacherGNN --N_exp=2 \
      --epochs=200 --whetherHasSE=100 --se_reg=32
"""
import argparse
import dataclasses
import json

import numpy as np


def parse_args(argv=None):
    from gnn_tail_generalization.config import Config

    parser = argparse.ArgumentParser(
        description="Tail and cold start generalization"
    )
    for f in dataclasses.fields(Config):
        if f.name in ("TeacherGNN", "StudentBaseMLP", "preStep", "midStep",
                      "lpStep"):
            continue  # derived sub-configs
        default = f.default if f.default is not dataclasses.MISSING else None
        ftype = f.type if isinstance(f.type, type) else type(default)
        _optional_types = {"skip_weight": float, "num_groups": int}
        if ftype is bool or isinstance(default, bool):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        elif f.name in _optional_types:
            parser.add_argument(f"--{f.name}", type=_optional_types[f.name],
                                default=None)
        elif isinstance(default, (int, float, str)) or default is None:
            cast = type(default) if default is not None else str
            parser.add_argument(f"--{f.name}", type=cast, default=None)
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--epoch_block", type=int, default=0,
                        help="epochs per jitted scan block (amortizes "
                             "dispatch and host-sync latency); "
                             "0 = auto (min(50, epochs//4), 1 for short "
                             "runs). Records are bitwise-identical "
                             "across block sizes")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="devices in the 1-D ('graph',) mesh; >1 row-"
                             "shards the graph (DistGraph ring SpMM) and "
                             "trains the full teacher across devices")
    ns = parser.parse_args(argv)
    overrides = {
        k: v for k, v in vars(ns).items()
        if v is not None and k not in ("data_root", "log_every",
                                       "epoch_block", "n_devices")
    }
    # cast int-encoded bools back
    for f in dataclasses.fields(Config):
        if f.name in overrides and isinstance(f.default, bool):
            overrides[f.name] = bool(overrides[f.name])
    return (overrides, ns.data_root, ns.log_every, ns.epoch_block,
            ns.n_devices)


def run_i2gtl(cfg, data_root, log_every):
    """exp_mode=I2_GTL: link-prediction transfer learning
    (trainer_link_prediction.py standalone mode)."""
    import numpy as np

    from gnn_tail_generalization.linkpred import model as lpm
    from gnn_tail_generalization.linkpred import surgery

    lcfg = lpm.LinkPredConfig()
    try:
        from gnn_tail_generalization.data.ogb import load_ogbl_graph

        g, _ = load_ogbl_graph(data_root, "ogbl-citation2")
        g2, se = surgery.transfer_surgery_node_year(g, "i2t")
    except FileNotFoundError:
        print("NOTE: no ogbl raw files; synthetic transfer stand-in.")
        from gnn_tail_generalization.data.synthetic import (
            fast_powerlaw_graph,
        )

        rng = np.random.default_rng(0)
        n = 2000
        g = surgery.GraphData(
            x=rng.normal(size=(n, 64)).astype(np.float32),
            edge_index=fast_powerlaw_graph(n, 10000, 0),
            node_year=rng.integers(2010, 2019, n),
            keys=np.arange(n),
        )
        g2, se = surgery.transfer_surgery_node_year(g, "i2t", drop_rate=0.0)
    out = lpm.train_linkpred(lcfg, g2.x, g2.edge_index, g2.n_node,
                             epochs=5, runs=2, split_edge=se,
                             log_every=log_every)
    print(json.dumps(out["stats"]))


def main(argv=None):
    """Runs the experiment ``argv`` (default: the command line) describes.
    Returns ``(columns, records)`` with records ``[seeds, epochs, cols]``,
    or the result dict of pure label propagation."""
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import load_dataset, prepare
    from gnn_tail_generalization.train import loops

    (overrides, data_root, log_every, epoch_block,
     n_devices) = parse_args(argv)
    cfg = build_config(**overrides)
    if epoch_block == 0:
        # auto: records are bitwise-identical across block sizes, so
        # blocking is a pure host-sync win; short runs keep per-epoch
        # stepping (one compiled program, minimal compile)
        epoch_block = 1 if cfg.epochs < 40 else min(50, cfg.epochs // 4)
    if cfg.exp_mode == "I2_GTL" and cfg.task != "nodeC":
        return run_i2gtl(cfg, data_root, log_every)
    print(f"Configs:\n  dataset={cfg.dataset} train_which={cfg.train_which} "
          f"type_trick={cfg.type_trick} num_layers={cfg.num_layers} "
          f"dim_hidden={cfg.dim_hidden}")

    rex = cell = None
    if cfg.prog:
        # tensorRex batch-grid resumption (main.py:54-124): skip completed
        # cells, persist the final row on completion
        from gnn_tail_generalization.utils.records import TensorRex

        # --prog "i-j-k" or "i-j-k/Si-Sj-Sk" (the reference's prog string
        # carries the grid shape, main.py:29-31). Without an explicit
        # shape, an existing rex file defines it; a fresh file sizes the
        # grid to contain the cell.
        spec = cfg.prog.replace(",", "-")
        shape = None
        if "/" in spec:
            cell_s, shape_s = spec.split("/")
            cell = tuple(int(v) for v in cell_s.split("-"))
            shape = tuple(int(v) for v in shape_s.split("-"))
        else:
            cell = tuple(int(v) for v in spec.split("-"))
        rex = TensorRex(f"{cfg.records_path}/{cfg.rexName}",
                        grid_shape=shape or tuple(c + 1 for c in cell),
                        record_len=8, grow_to_fit=shape is None)
        if rex.is_done(cell):
            print(f"rex cell {cell} already done; skipping")
            return

    data = load_dataset(cfg, data_root)
    if data.name.startswith("synthetic"):
        print(f"NOTE: no raw dataset files found under {data_root!r}; "
              f"running on a synthetic stand-in with the preset shapes.")
        n = data.x.shape[0]
        cfg = dataclasses.replace(
            cfg, N_nodes=n, num_feats=data.x.shape[1],
            num_classes=int(data.y.max()) + 1,
        )
        from gnn_tail_generalization.config import apply_arch_configs
        cfg = apply_arch_configs(cfg)
    if n_devices > 1:
        # multi-device: 1-D ('graph',) mesh, DistGraph ring SpMM — the full
        # teacher (tricks/norms/SE/Adam/eval) runs sharded via train_teacher
        import jax

        from gnn_tail_generalization.data.datasets import prepare_sharded
        from gnn_tail_generalization.parallel.distributed import (
            make_graph_mesh,
        )

        sharded_ok = ("TeacherGNN", "SEMLP", "StudentBaseMLP", "GraphMLP",
                      "LP")
        assert cfg.train_which in sharded_ok, (
            f"--n_devices>1 supports train_which in {sharded_ok} "
            "(the linkpred trainer shards via linkpred.model mesh= arg)")
        avail = len(jax.devices())
        assert n_devices <= avail, f"{n_devices} devices requested, {avail} present"
        mesh = make_graph_mesh(n_devices)
        pd = prepare_sharded(data, cfg, mesh)
    else:
        pd = prepare(data, cfg)

    all_records = []
    if (cfg.train_which == "TeacherGNN" and cfg.N_exp > 1
            and n_devices == 1):
        # vmapped population training: all seeds in one compiled step
        from gnn_tail_generalization.train.multiseed import (
            train_teacher_multiseed,
        )

        seeds = [cfg.random_seed + s for s in range(cfg.N_exp)]
        results = train_teacher_multiseed(cfg, pd, seeds,
                                          log_every=log_every)
        res = results[-1]
        for seed, r in enumerate(results):
            all_records.append(r.records)
            print(f"seed {seed}: " + " ".join(
                f"{c}={r.records[-1, i]:.2f}"
                for i, c in enumerate(r.columns)
            ))
    else:
        for seed in range(cfg.N_exp):
            if cfg.train_which == "TeacherGNN":
                res = loops.train_teacher(
                    cfg, pd, seed=cfg.random_seed + seed,
                    log_every=log_every, epoch_block=epoch_block,
                )
            else:
                res = loops.run_experiment(
                    cfg, pd, seed=cfg.random_seed + seed,
                    log_every=log_every, epoch_block=epoch_block,
                )
            if isinstance(res, dict):  # pure LP
                print(json.dumps(res))
                if rex is not None:
                    rex.record(cell, list(res.values()))
                    print(f"rex cell {cell} recorded")
                return res
            all_records.append(res.records)
            print(f"seed {seed}: " + " ".join(
                f"{c}={res.records[-1, i]:.2f}"
                for i, c in enumerate(res.columns)
            ))

    stacked = np.stack(all_records)  # [seeds, epochs, cols]
    if overrides.get("records_path") or overrides.get("records_desc"):
        # wzRec-style persistence (utils.py:1005-1051): one npy per metric
        from gnn_tail_generalization.utils.records import save_curve

        rdir = f"{cfg.records_path}/{cfg.records_desc or cfg.dataset}"
        for i, c in enumerate(res.columns):
            save_curve(stacked[:, :, i], f"{c}@{cfg.train_which}", rdir)
        print(f"records saved under {rdir}")
    final = stacked[:, -1, :]
    cols = res.columns
    print("=== mean ± std over seeds (final epoch) ===")
    for i, c in enumerate(cols):
        print(f"  {c}: {final[:, i].mean():.2f} ± {final[:, i].std():.2f}")
    best_i = cols.index("acc_test") if "acc_test" in cols else 0
    print(f"best acc_test over epochs, per seed: "
          f"{stacked[:, :, best_i].max(axis=1)}")
    if rex is not None:
        rex.record(cell, final.mean(axis=0))
        print(f"rex cell {cell} recorded to {cfg.records_path}/{cfg.rexName}")
    return cols, stacked


if __name__ == "__main__":
    main()
