"""Command line of the port: `python -m multimodal_outage_tpu_torch <cmd>`.

  synth    — write a synthetic packed store (same layout as the JAX
             package's, so either package reads the other's)
  stats    — print the store's normalization {"mean", "std"}
  serve    — sweep a held-out hurricane through the serving engine (Graph
             WaveNet, or DCRNN with --st_gnn dcrnn) with a checkpoint's,
             an .npz's or seeded weights, and print the metrics JSON (and
             per-request latency with --latency_stats)
  train    — train the fusion model (leave one hurricane out), write
             metrics and checkpoints under logs/<job_id>, and print the
             best model's val and test metrics JSON
  evaluate — sweep a held-out hurricane with a checkpoint through the
             trainable model in eval mode, print the test metrics JSON,
             and write predictions, risk maps and rasters on request

serve, train and evaluate run on the card unless --device cpu is given;
without a card they raise rather than falling back. Every command prints
one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from multimodal_outage_tpu_torch.core.registry import HURRICANES


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="multimodal_outage_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("synth", help="Generate a synthetic packed store")
    p.add_argument("--out_dir", type=str, default="data/synthetic")
    p.add_argument("--n_counties", type=int, default=67)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--margin", type=int, default=45)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--cases", type=str, default=",".join(HURRICANES),
        help="comma-separated hurricanes whose ±margin windows the store covers",
    )
    p.add_argument("--pixel_noise", type=float, default=0.0,
                   help="stddev of an extra per-pixel multiplicative noise (0: the "
                   "spatially smooth default; >0 for scheduled-sampling studies)")

    p = sub.add_parser("stats", help="Normalization mean/std of a store")
    p.add_argument("--data_dir", type=str, default="data/synthetic")
    p.add_argument("--dataset_range", type=int, default=30)

    p = sub.add_parser("serve", help="Serve a held-out hurricane through the engine")
    p.add_argument("--data_dir", type=str, default="data/synthetic")
    p.add_argument("--case", type=str, default="michael")
    p.add_argument("--dataset_range", type=int, default=30)
    p.add_argument("--horizon", type=int, default=7)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument(
        "--compute_dtype", type=str, default="bfloat16",
        choices=("bfloat16", "float32"),
    )
    p.add_argument("--st_gnn", type=str, default="gwnet", choices=("gwnet", "dcrnn"),
                   help="spatio-temporal GNN: Graph WaveNet or DCRNN, each as one kernel")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", type=str, help=".npz written by weights.save_npz")
    src.add_argument("--seed", type=int, help="random weights from this seed")
    src.add_argument("--checkpoint_path", type=str,
                     help="checkpoint directory written by train (its best step)")
    p.add_argument("--save_preds", type=str, default=None,
                   help="write the swept predictions to <dir>/preds.npy")
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--latency_stats", action="store_true",
                   help="also report p50/p90 per-request latency")

    p = sub.add_parser("train", help="Train the fusion model")
    p.add_argument("--case", type=str, default="michael", help="held-out hurricane")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--job_id", type=str, default="test",
                   help="run directory logs/<job_id> (metrics, checkpoints)")
    p.add_argument("--teacher_forcing", type=float, default=0.0,
                   help="DCRNN scheduled sampling: the probability that a decoder step "
                   "is fed the encoded ground-truth frame instead of its own output "
                   "(train steps only; 0 turns it off)")
    p.add_argument("--tf_decay_steps", type=int, default=0,
                   help="with --teacher_forcing: the inverse-sigmoid decay constant τ, "
                   "p(step) = p0·τ/(τ + e^{step/τ}); 0 keeps p constant")
    _model_flags(p)

    p = sub.add_parser("evaluate", help="Sweep a held-out hurricane with a checkpoint")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="checkpoint directory written by train (its best step)")
    p.add_argument("--case", type=str, default="idalia", help="held-out hurricane")
    p.add_argument("--save_preds", type=str, default=None,
                   help="write preds.npy and targets.npy to this directory")
    p.add_argument("--metrics_json", type=str, default=None,
                   help="write the test metrics to this JSON file")
    p.add_argument("--risk_maps", type=str, default=None,
                   help="write percent-of-normal risk-map PNGs here")
    p.add_argument("--raster_maps", type=str, default=None,
                   help="write prediction raster PNGs here")
    _model_flags(p)
    return parser


def _model_flags(p: argparse.ArgumentParser) -> None:
    """The data, model and device flags that train and evaluate share."""
    p.add_argument("--st_gnn", type=str, default="gwnet", choices=("gwnet", "dcrnn"),
                   help="spatio-temporal GNN: Graph WaveNet or DCRNN")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--data_dir", type=str, default="data/synthetic")
    p.add_argument("--dataset_range", type=int, default=30)
    p.add_argument("--horizon", type=int, default=7)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--pool", choices=("reduce_window", "pairwise", "pallas"),
                   default="reduce_window",
                   help="2×2 max-pool: F.max_pool2d, strided-slice maximums, "
                   "or the max-pool kernel pair (ops/max_pool.py)")
    p.add_argument("--bn_two_pass", action="store_true",
                   help="two-pass BatchNorm statistics instead of the single sweep")
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")


def _config(args: argparse.Namespace, **train):
    """The Config of train's and evaluate's flags; `train` adds
    TrainConfig fields."""
    from multimodal_outage_tpu_torch.core.config import (
        Config,
        DataConfig,
        DCRNNConfig,
        ModelConfig,
        TrainConfig,
    )

    return Config(
        data=DataConfig(
            data_dir=args.data_dir, horizon=args.horizon,
            dataset_range=args.dataset_range, image_size=args.image_size,
        ),
        model=ModelConfig(
            compute_dtype=args.compute_dtype, pool=args.pool,
            bn_single_pass=not args.bn_two_pass,
            st_gnn=args.st_gnn,
            dcrnn=DCRNNConfig(teacher_forcing=getattr(args, "teacher_forcing", 0.0),
                              tf_decay_steps=getattr(args, "tf_decay_steps", 0)),
        ),
        train=TrainConfig(batch_size=args.batch_size, **train),
    )


def train_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `train`; returns the final best-model metrics (train/loop.fit)."""
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.train.loop import fit

    device = resolve_device(args.device)  # fail before any work
    cfg = _config(args, epochs=args.epochs, seed=args.seed, job_id=args.job_id)
    return fit(cfg, test_case=args.case, device=device)


def evaluate_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `evaluate` (JAX cli.py:442-500): train/loop.predict on the
    checkpoint's best step, then the files asked for. Returns the test
    metrics, the window and forward counts, and what was written."""
    import numpy as np

    from multimodal_outage_tpu_torch.train.loop import predict

    if args.risk_maps or args.raster_maps:
        import matplotlib  # noqa: F401  (fail before the sweep, not after)
    cfg = _config(args)
    preds, targets, metrics = predict(cfg, args.checkpoint_path, args.case,
                                      device=args.device)
    out: Dict[str, Any] = {
        "metrics": metrics, "windows": len(preds),
        "forwards": -(-len(preds) // args.batch_size),
        "device": args.device or "cuda",
    }
    if args.metrics_json:
        os.makedirs(os.path.dirname(args.metrics_json) or ".", exist_ok=True)
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
        out["metrics_json"] = args.metrics_json
    if args.save_preds:
        os.makedirs(args.save_preds, exist_ok=True)
        np.save(os.path.join(args.save_preds, "preds.npy"), preds)
        np.save(os.path.join(args.save_preds, "targets.npy"), targets)
        out["save_preds"] = args.save_preds
    if args.risk_maps or args.raster_maps:
        from multimodal_outage_tpu_torch.core.registry import leave_one_out
        from multimodal_outage_tpu_torch.data.dataset import WindowDataset
        from multimodal_outage_tpu_torch.data.store import load_store
        from multimodal_outage_tpu_torch.viz import maps

        store = load_store(cfg.data.data_dir)
        _, test_cases = leave_one_out(args.case)
        test_ds = WindowDataset.from_case_study(
            store, test_cases, cfg.data.dataset_range, cfg.data.horizon
        )
        mean, std = cfg.data.mean, cfg.data.std
        if args.risk_maps:
            fut = test_ds.future_window_dates(np.arange(len(test_ds)))
            out["risk_maps"] = len(maps.save_risk_maps(
                preds, store, args.risk_maps, mean=mean, std=std, future_dates=fut))
        if args.raster_maps:
            out["raster_maps"] = len(maps.save_prediction_rasters(
                preds, args.raster_maps, mean=mean, std=std,
                county_names=store.county_names, max_samples=4))
    return out


def serve_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `serve`; returns the JSON-able result (metrics, latency,
    forwards, device)."""
    import numpy as np

    from multimodal_outage_tpu_torch.core.checkpoint import (
        require_checkpoints,
        restore_variables,
    )
    from multimodal_outage_tpu_torch.core.config import Config, DataConfig, ModelConfig
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.data.adjacency import config_supports
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import ServingModel, serve_eval
    from multimodal_outage_tpu_torch.weights import init_variables, load_npz

    if args.checkpoint_path is not None:
        require_checkpoints(args.checkpoint_path)
    device = resolve_device(args.device)  # fail before any work
    store = load_store(args.data_dir)
    cfg = Config(
        data=DataConfig(
            data_dir=args.data_dir, image_size=args.image_size,
            n_counties=store.n_counties, horizon=args.horizon,
            dataset_range=args.dataset_range,
        ),
        model=ModelConfig(compute_dtype=args.compute_dtype, st_gnn=args.st_gnn),
    )
    if args.checkpoint_path is not None:
        # the best step's params and batch_stats (JAX train/loop.py:773-848)
        variables = restore_variables(args.checkpoint_path)
    elif args.weights is not None:
        variables = load_npz(args.weights)
    else:
        variables = init_variables(
            cfg.model, args.horizon, store.n_counties, args.seed, args.image_size
        )
    # the supports predict builds for the same Config
    serve = ServingModel(
        cfg.model, variables, config_supports(cfg, store), horizon=args.horizon,
        device=device,
    )
    preds: Optional[List[np.ndarray]] = [] if args.save_preds else None
    metrics, latency, forwards = serve_eval(
        cfg.data, serve, store, args.case, args.batch_size,
        max_batches=args.max_batches, latency_stats=args.latency_stats,
        collect_preds=preds,
    )
    out: Dict[str, Any] = {"metrics": metrics, "forwards": forwards,
                           "device": device.type}
    if latency:
        out["latency"] = latency
    if args.save_preds:
        os.makedirs(args.save_preds, exist_ok=True)
        np.save(os.path.join(args.save_preds, "preds.npy"), np.concatenate(preds))
        out["save_preds"] = args.save_preds
    return out


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse and run one command; returns what main prints."""
    args = _parser().parse_args(argv)
    if args.command == "synth":
        from multimodal_outage_tpu_torch.data.synthetic import generate_store

        cases = [c for c in args.cases.split(",") if c]
        unknown = sorted(set(cases) - set(HURRICANES))
        if unknown:
            raise ValueError(f"unknown hurricanes {unknown}; pick from {sorted(HURRICANES)}")
        frames, dates = generate_store(
            args.out_dir, n_counties=args.n_counties, image_size=args.image_size,
            margin=args.margin, seed=args.seed,
            hurricanes={c: HURRICANES[c] for c in cases}, pixel_noise=args.pixel_noise,
        )
        return {"out_dir": args.out_dir, "frames": list(frames.shape),
                "dates": int(dates.shape[0])}
    if args.command == "stats":
        from multimodal_outage_tpu_torch.data.stats import compute_mean_std
        from multimodal_outage_tpu_torch.data.store import load_store

        mean, std = compute_mean_std(load_store(args.data_dir), dataset_range=args.dataset_range)
        return {"mean": mean, "std": std}
    return {"serve": serve_command, "train": train_command,
            "evaluate": evaluate_command}[args.command](args)


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
