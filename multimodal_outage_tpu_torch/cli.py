"""Command line of the port: `python -m multimodal_outage_tpu_torch <cmd>`.

  synth  — write a synthetic packed store (same layout as the JAX
           package's, so either package reads the other's)
  serve  — sweep a held-out hurricane through the serving engine (Graph
           WaveNet, or DCRNN with --st_gnn dcrnn) and print the metrics
           JSON (and per-request latency with --latency_stats)
  train  — train the fusion model (leave one hurricane out), write metrics
           and checkpoints under logs/<job_id>, and print the best
           model's val and test metrics JSON

serve and train run on the card unless --device cpu is given; without a
card they raise rather than falling back.
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--latency_stats", action="store_true",
                   help="also report p50/p90 per-request latency")

    p = sub.add_parser("train", help="Train the fusion model (Graph WaveNet)")
    p.add_argument("--case", type=str, default="michael", help="held-out hurricane")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--job_id", type=str, default="test",
                   help="run directory logs/<job_id> (metrics, checkpoints)")
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
    return parser


def train_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `train`; returns the final best-model metrics (train/loop.fit)."""
    from multimodal_outage_tpu_torch.core.config import (
        Config,
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.train.loop import fit

    device = resolve_device(args.device)  # fail before any work
    cfg = Config(
        data=DataConfig(
            data_dir=args.data_dir, horizon=args.horizon,
            dataset_range=args.dataset_range, image_size=args.image_size,
        ),
        model=ModelConfig(
            compute_dtype=args.compute_dtype, pool=args.pool,
            bn_single_pass=not args.bn_two_pass,
        ),
        train=TrainConfig(
            epochs=args.epochs, batch_size=args.batch_size, seed=args.seed,
            job_id=args.job_id,
        ),
    )
    return fit(cfg, test_case=args.case, device=device)


def serve_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `serve`; returns the JSON-able result (metrics, latency,
    forwards, device)."""
    from multimodal_outage_tpu_torch.core.config import DataConfig, ModelConfig
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import ServingModel, serve_eval
    from multimodal_outage_tpu_torch.weights import init_variables, load_npz

    device = resolve_device(args.device)  # fail before any work
    store = load_store(args.data_dir)
    data_cfg = DataConfig(
        data_dir=args.data_dir, image_size=args.image_size,
        n_counties=store.n_counties, horizon=args.horizon,
        dataset_range=args.dataset_range,
    )
    model_cfg = ModelConfig(compute_dtype=args.compute_dtype, st_gnn=args.st_gnn)
    if args.weights is not None:
        variables = load_npz(args.weights)
    else:
        variables = init_variables(
            model_cfg, args.horizon, store.n_counties, args.seed, args.image_size
        )
    supports = model_supports(model_cfg, store.n_counties, store.county_names)
    serve = ServingModel(
        model_cfg, variables, supports, horizon=args.horizon, device=device
    )
    metrics, latency, forwards = serve_eval(
        data_cfg, serve, store, args.case, args.batch_size,
        max_batches=args.max_batches, latency_stats=args.latency_stats,
    )
    out: Dict[str, Any] = {"metrics": metrics, "forwards": forwards,
                           "device": device.type}
    if latency:
        out["latency"] = latency
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
            hurricanes={c: HURRICANES[c] for c in cases},
        )
        return {"out_dir": args.out_dir, "frames": list(frames.shape),
                "dates": int(dates.shape[0])}
    if args.command == "train":
        return train_command(args)
    return serve_command(args)


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
