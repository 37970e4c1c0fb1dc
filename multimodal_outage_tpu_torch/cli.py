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
  pretrain-d2v — pretrain a Date2Vec bundle (.npz, the JAX package's
             names) for --d2v_bundle, print {"out", "final_loss"}

serve, train, evaluate and pretrain-d2v run on the card unless --device
cpu is given; without a card they raise rather than falling back. Every
command prints one JSON object as its last line; train --num_runs N > 1
prints {"runs": [<run 0's results>, ...]}.
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
    _graph_flags(p)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", type=str, help=".npz written by weights.save_npz")
    # not TrainConfig.seed: serve, like evaluate, draws a small store's
    # synthetic graph at the default seed (ROADMAP §C)
    src.add_argument("--seed", type=int, dest="weights_seed",
                     help="random weights from this seed")
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
    p.add_argument("--num_runs", type=int, default=1,
                   help="repeat the run N times: run i is <job_id>_r<i> at seed + i")
    p.add_argument("--resume", action="store_true",
                   help="continue from logs/<job_id>'s latest checkpoint, if it has one")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars to logs/<job_id>/tb (needs "
                   "tensorboardX or torch's writer; metrics.jsonl is always written)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of a few train steps here")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first NaN or inf of a train step")
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

    p = sub.add_parser("pretrain-d2v", help="Pretrain a Date2Vec bundle for --d2v_bundle")
    p.add_argument("--out", type=str, default="d2v_model/d2v.npz")
    p.add_argument("--k", type=int, default=64, help="embedding width (time_embed_size)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")
    return parser


def _graph_flags(p: argparse.ArgumentParser) -> None:
    """The model and graph flags that train, evaluate and serve share
    with the JAX CLI (its cli.py:35-81)."""
    p.add_argument("--n_counties", type=int, default=67,
                   help="recorded in the config; the store's county count is used")
    p.add_argument("--input_channels", type=int, default=1)
    p.add_argument("--output_channels", type=int, default=1)
    p.add_argument("--d2v_bundle", type=str, default=None,
                   help=".npz Date2Vec bundle from pretrain-d2v, installed into fresh "
                   "weights (a checkpoint's own Date2Vec stands)")
    p.add_argument("--adjacency", type=str, default=None,
                   help="adjacency CSV (default: the packaged Florida graph); its county "
                   "order must be the store's")
    p.add_argument("--adjtype", type=str, default=None,
                   choices=("identity", "transition", "doubletransition"),
                   help="Graph WaveNet's static supports (default identity, the "
                   "reference's degenerate doubletransition)")
    p.add_argument("--no_gcn", action="store_true",
                   help="no graph convolution in Graph WaveNet: residual 1×1s in place of "
                   "the diffusion GCNs (reference gcn_bool=False)")
    p.add_argument("--no_addaptadj", action="store_true",
                   help="no learned adaptive adjacency in Graph WaveNet")
    p.add_argument("--svd_aptinit", action="store_true",
                   help="train: start the node embeddings from the SVD of the first static "
                   "support (reference randomadj=False)")
    p.add_argument("--gwnet_kernel_size", type=int, default=None,
                   help="Graph WaveNet's temporal kernel (default 1; >1 is the dilated "
                   "gated TCN, receptive field 13 at 2)")


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
    _graph_flags(p)


def _config(args: argparse.Namespace):
    """The Config of the parsed flags, field by field as the JAX CLI's
    _build_config (its cli.py:161-230) maps them; a flag a command lacks
    takes the field's default."""
    from multimodal_outage_tpu_torch.core.config import (
        Config,
        DataConfig,
        DCRNNConfig,
        GWNetConfig,
        ModelConfig,
        TrainConfig,
    )

    gwnet = {}
    if getattr(args, "adjtype", None):
        gwnet["adjtype"] = args.adjtype
    if getattr(args, "no_gcn", False):
        gwnet["gcn_bool"] = False
    if getattr(args, "no_addaptadj", False):
        gwnet["addaptadj"] = False
    if getattr(args, "svd_aptinit", False):
        gwnet["randomadj"] = False
    if getattr(args, "gwnet_kernel_size", None):
        gwnet["kernel_size"] = args.gwnet_kernel_size
    return Config(
        data=DataConfig(
            data_dir=args.data_dir, horizon=args.horizon, dataset_range=args.dataset_range,
            image_size=args.image_size, n_counties=args.n_counties,
        ),
        model=ModelConfig(
            st_gnn=args.st_gnn, input_channels=args.input_channels,
            output_channels=args.output_channels, compute_dtype=args.compute_dtype,
            d2v_bundle=args.d2v_bundle, pool=getattr(args, "pool", "reduce_window"),
            bn_single_pass=not getattr(args, "bn_two_pass", False),
            gwnet=GWNetConfig(**gwnet),
            dcrnn=DCRNNConfig(teacher_forcing=getattr(args, "teacher_forcing", 0.0),
                              tf_decay_steps=getattr(args, "tf_decay_steps", 0)),
        ),
        train=TrainConfig(
            epochs=getattr(args, "epochs", 5), batch_size=args.batch_size,
            job_id=getattr(args, "job_id", "test"), seed=getattr(args, "seed", 42),
            resume=getattr(args, "resume", False),
            tensorboard=getattr(args, "tensorboard", False),
            profile_dir=getattr(args, "profile_dir", None),
            debug_nans=getattr(args, "debug_nans", False),
        ),
        adjacency_csv=args.adjacency,
    )


def train_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `train`; returns the final best-model metrics (train/loop.fit),
    or with --num_runs N > 1 {"runs": [...]}: run i is job <job_id>_r<i>
    at seed + i (JAX cli.py:421-429)."""
    import dataclasses

    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.train.loop import fit

    device = resolve_device(args.device)  # fail before any work
    cfg = _config(args)
    if args.num_runs == 1:
        return fit(cfg, test_case=args.case, device=device)
    runs = []
    for i in range(args.num_runs):
        train = dataclasses.replace(cfg.train, job_id=f"{cfg.train.job_id}_r{i}",
                                    seed=cfg.train.seed + i)
        runs.append(fit(cfg.replace(train=train), test_case=args.case, device=device))
    return {"runs": runs}


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
    forwards, device). The engine is built over the supports of the
    flags' adjtype, addaptadj and adjacency; --d2v_bundle replaces the
    Date2Vec of --seed's or --weights' variables, not a checkpoint's."""
    import numpy as np

    from multimodal_outage_tpu_torch.core.checkpoint import (
        require_checkpoints,
        restore_variables,
    )
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.data.adjacency import config_supports
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import ServingModel, serve_eval
    from multimodal_outage_tpu_torch.train.date2vec_pretrain import install_bundle, load_bundle
    from multimodal_outage_tpu_torch.weights import init_variables, load_npz

    if args.checkpoint_path is not None:
        require_checkpoints(args.checkpoint_path)
    device = resolve_device(args.device)  # fail before any work
    store = load_store(args.data_dir)
    cfg = _config(args)
    if args.checkpoint_path is not None:
        # the best step's params and batch_stats (JAX train/loop.py:773-848)
        variables = restore_variables(args.checkpoint_path)
    else:
        if args.weights is not None:
            variables = load_npz(args.weights)
        else:
            variables = init_variables(cfg.model, args.horizon, store.n_counties,
                                       args.weights_seed, args.image_size)
        if cfg.model.d2v_bundle:
            variables["params"] = install_bundle(variables["params"],
                                                 load_bundle(cfg.model.d2v_bundle))
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


def pretrain_d2v_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `pretrain-d2v` (JAX cli.py:539-549): train the Date2Vec
    autoencoder, save its bundle to --out; returns {"out", "final_loss"}."""
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.train.date2vec_pretrain import (
        pretrain_date2vec,
        save_bundle,
    )

    device = resolve_device(args.device)  # fail before any work
    params, loss = pretrain_date2vec(k=args.k, steps=args.steps, device=device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_bundle(params, args.out)
    return {"out": args.out, "final_loss": loss}


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
    return {"serve": serve_command, "train": train_command, "evaluate": evaluate_command,
            "pretrain-d2v": pretrain_d2v_command}[args.command](args)


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
