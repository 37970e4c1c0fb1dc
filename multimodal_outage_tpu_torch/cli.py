"""Command line of the port: `python -m multimodal_outage_tpu_torch <cmd>`.

  synth    — write a synthetic packed store (same layout as the JAX
             package's, so either package reads the other's)
  stats    — print the store's normalization {"mean", "std"}
  serve    — sweep a held-out hurricane through the serving engine (Graph
             WaveNet, or DCRNN or GMAN with --st_gnn) with a checkpoint's,
             an .npz's or seeded weights, and print the metrics JSON (and
             per-request latency with --latency_stats)
  train    — train the fusion model (leave one hurricane out), write
             metrics and checkpoints under logs/<job_id>, and print the
             best model's val and test metrics JSON
  evaluate — sweep a held-out hurricane with a checkpoint through the
             trainable model in eval mode, print the test metrics JSON,
             and write predictions, risk maps and rasters on request
  import-torch — convert a reference Lightning checkpoint (.ckpt, or a
             bare Modified_UNET state_dict, with a Date2Vec .pth) into a
             checkpoint directory that evaluate, serve --checkpoint_path
             and train --resume read; print {"out", "torch_keys", "leaves"}
  pretrain-d2v — pretrain a Date2Vec bundle (.npz, the JAX package's
             names) for --d2v_bundle, print {"out", "final_loss"}
  ingest   — pack a {county}/{Y_m_d}.npy|pickle tree of raw rasters into
             a store (data/acquisition.py)
  ingest-monthly — attach a {county}/monthly_{Y}_{M}.npy tree to a store
             as its risk-map baseline sidecar
  download-missing — fetch the days each {county} directory under
             --out_dir lacks in the hurricanes' ±--margin_days windows
             from NASA's Black Marble servers (needs the network,
             NASA_BEARER_TOKEN, blackmarblepy, geopandas and pandas) and
             print {"counties", "dates_fetched", "per_county"}
  bench    — run one benchmark config (benchmarks.py) and print its
             {"metric", "value", "unit", "vs_baseline", "detail"} line

serve, train, evaluate, import-torch, pretrain-d2v, ingest,
ingest-monthly and bench run on the card unless --device cpu is given;
without a card they raise rather than falling back. download-missing is
host code and takes no --device. Every command prints one JSON
object as its last line; train --num_runs N > 1 prints {"runs": [<run 0's
results>, ...]}; import-torch, ingest and ingest-monthly print the JAX
CLI's line before it.

train, evaluate, serve and import-torch take every flag that the JAX
CLI's command of the same name takes, with its defaults, into the same
Config fields. --mesh_data, --mesh_model and --mesh_time run train,
evaluate and serve on a mesh of ranks (core/mesh.py; the ranks are
started by parallel/launch.py, rank 0's result is printed), with
--shard_store splitting the device store's dates over the data ranks;
train's --coordinator_address host:port --num_processes P --process_id i
makes this process start its host's ranks of a P-host run
(core/mesh.py initialize_distributed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from multimodal_outage_tpu_torch.core.config import ST_GNNS

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
    p.add_argument("--case", type=str, default="michael")
    _model_flags(p)
    _mesh_flags(p)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", type=str, help=".npz written by weights.save_npz")
    # not TrainConfig.seed: serve, like evaluate, draws a small store's
    # synthetic graph at the default seed (ROADMAP §C)
    src.add_argument("--seed", type=int, dest="weights_seed",
                     help="random weights from this seed")
    src.add_argument("--checkpoint_path", type=str,
                     help="checkpoint directory written by train or import-torch (its best "
                     "step)")
    p.add_argument("--save_preds", type=str, default=None,
                   help="write the swept predictions to <dir>/preds.npy")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--latency_stats", action="store_true",
                   help="also report p50/p90 per-request latency")

    p = sub.add_parser("train", help="Train the fusion model")
    p.add_argument("--case", type=str, default="michael", help="held-out hurricane")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--job_id", type=str, default="test",
                   help="run directory logs/<job_id> (metrics, checkpoints)")
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
    _mesh_flags(p)
    p.add_argument("--shard_store", action="store_true",
                   help="partition the device frame store over the data mesh axis; on one "
                   "device that partition is the whole store, as in the JAX package")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="multi-host: host:port where the processes' ranks meet")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-host: the number of processes (hosts)")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-host: this process's index")

    p = sub.add_parser("evaluate", help="Sweep a held-out hurricane with a checkpoint")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="checkpoint directory written by train or import-torch (its best step)")
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
    _mesh_flags(p)

    p = sub.add_parser("import-torch", help="Convert a reference Lightning checkpoint (or a "
                       "bare Modified_UNET state_dict) into a checkpoint directory that "
                       "evaluate, serve and train --resume read")
    p.add_argument("--checkpoint", type=str, required=True, help="reference .ckpt or .pth")
    p.add_argument("--d2v_pth", type=str, default=None,
                   help="reference Date2Vec .pth (whole-module pickle or state_dict): its "
                   "fc1/fc2 replace the template's Date2Vec encoder")
    p.add_argument("--out", type=str, required=True, help="checkpoint directory to write")
    p.add_argument("--no_strict", action="store_true",
                   help="tolerate missing and extra reference keys instead of raising")
    _model_flags(p)

    p = sub.add_parser("pretrain-d2v", help="Pretrain a Date2Vec bundle for --d2v_bundle")
    p.add_argument("--out", type=str, default="d2v_model/d2v.npz")
    p.add_argument("--k", type=int, default=64, help="embedding width (time_embed_size)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")

    p = sub.add_parser("ingest", help="Pack per-county/day raw files into the store layout")
    p.add_argument("--raw_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="where the rasters are resized; default: cuda (raises if there "
                   "is no card)")

    p = sub.add_parser("ingest-monthly", help="Attach {county}/monthly_Y_M.npy composites "
                       "to an existing store as the risk-map baseline sidecar")
    p.add_argument("--raw_dir", type=str, required=True)
    p.add_argument("--store_dir", type=str, required=True)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="where the rasters are resized; default: cuda (raises if there "
                   "is no card)")

    p = sub.add_parser("download-missing", help="Re-fetch only the dates each county "
                       "directory is missing (reference eda/util.py:216-234): recovery after "
                       "a partial download. Needs NASA_BEARER_TOKEN, blackmarblepy, geopandas "
                       "and pandas, and the network")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--margin_days", type=int, default=90)

    p = sub.add_parser("bench", help="Run one benchmark config")
    p.add_argument("--config", type=str, default="unet_train")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")
    return parser


def _grad_accum_arg(v: str) -> int:
    """--grad_accum value: a positive int, or 'auto' (= 0 internally,
    TrainConfig.grad_accum) for the out-of-memory fallback (JAX cli.py:
    22-32)."""
    if v.strip().lower() == "auto":
        return 0
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {v!r}"
        ) from None


def _model_flags(p: argparse.ArgumentParser) -> None:
    """The flags of the JAX CLI's _add_common_model_flags (its cli.py:
    35-140), which train, evaluate, serve and import-torch take, with its
    defaults, and --device. Each is recorded in the Config; a command
    reads the ones its work uses (only train's steps read the memory
    flags, and serve's engine has its own pool, BatchNorm folding and
    self-feeding decoder, as the JAX engine has)."""
    p.add_argument("--st_gnn", type=str, default="gwnet", choices=ST_GNNS,
                   help="spatio-temporal GNN: Graph WaveNet, DCRNN, or GMAN (graph "
                   "multi-attention; the port's own, GMANConfig's widths)")
    p.add_argument("--horizon", type=int, default=7)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--data_dir", type=str, default="data/synthetic")
    p.add_argument("--dataset_range", type=int, default=30)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--n_counties", type=int, default=67,
                   help="import-torch: the template's county count; the others record it "
                   "and use the store's")
    p.add_argument("--input_channels", type=int, default=1)
    p.add_argument("--output_channels", type=int, default=1)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"))
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
    p.add_argument("--teacher_forcing", type=float, default=0.0,
                   help="train: DCRNN scheduled sampling, the probability that a decoder "
                   "step is fed the encoded ground-truth frame instead of its own output "
                   "(0 turns it off; evaluation and serving always self-feed)")
    p.add_argument("--tf_decay_steps", type=int, default=0,
                   help="with --teacher_forcing: the inverse-sigmoid decay constant τ, "
                   "p(step) = p0·τ/(τ + e^{step/τ}); 0 keeps p constant")
    p.add_argument("--bn_two_pass", action="store_true",
                   help="two-pass BatchNorm statistics instead of the single sweep")
    p.add_argument("--remat", action="store_true",
                   help="train: recompute U-Net conv blocks in the backward "
                   "(torch.utils.checkpoint) for less activation memory")
    p.add_argument("--remat_scope", choices=("all", "stem", "conv"), default="all",
                   help="with --remat: 'all' every block; 'stem' the top two resolutions' "
                   "blocks (inc, down1, up3, up4); 'conv' every block with the "
                   "convolution outputs kept, so only the BatchNorm/ReLU/pool/concat "
                   "between them is recomputed")
    p.add_argument("--grad_accum", type=_grad_accum_arg, default=1,
                   help="train: run each batch as N equal microbatches, forward and "
                   "backward one after another, then one update: the full batch's "
                   "gradients and serial-EMA BatchNorm statistics at one microbatch's "
                   "activation memory. 'auto' (or 0) starts one-shot and, when a step "
                   "runs out of device memory, retries it split finer")
    p.add_argument("--xla_vmem_limit_kib", type=int, default=49152,
                   help="recorded in the config for the JAX CLI's sake (an XLA TPU "
                   "compiler budget); the port does not read it")
    p.add_argument("--pool", choices=("reduce_window", "pairwise", "pallas"),
                   default="reduce_window",
                   help="2×2 max-pool of train and evaluate: F.max_pool2d, strided-slice "
                   "maximums, or the max-pool kernel pair (ops/max_pool.py)")
    p.add_argument("--device", type=str, default=None, choices=("cuda", "cpu"),
                   help="default: cuda (raises if there is no card)")


def _mesh_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's mesh axes (its _add_mesh_flags, cli.py:143-158), which
    train, evaluate and serve take; a mesh of more than one device runs
    on ranks (core/mesh.py)."""
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data-parallel axis (-1: every device left over, one on one card)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis (bottleneck MLP hidden dims)")
    p.add_argument("--mesh_time", type=int, default=1,
                   help="sequence-parallel axis (temporal window T)")


def _config(args: argparse.Namespace):
    """The Config of the parsed flags of train, evaluate, serve or
    import-torch, field by field as the JAX CLI's _build_config (its
    cli.py:161-230) maps them; a flag a command lacks takes the field's
    default. The port's own gman group (GMAN has no JAX counterpart) takes
    its window, 2·horizon steps, from --horizon."""
    from multimodal_outage_tpu_torch.core.config import (
        Config,
        DataConfig,
        DCRNNConfig,
        GMANConfig,
        GWNetConfig,
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )

    gwnet = {}
    if args.adjtype:
        gwnet["adjtype"] = args.adjtype
    if args.no_gcn:
        gwnet["gcn_bool"] = False
    if args.no_addaptadj:
        gwnet["addaptadj"] = False
    if args.svd_aptinit:
        gwnet["randomadj"] = False
    if args.gwnet_kernel_size:
        gwnet["kernel_size"] = args.gwnet_kernel_size
    return Config(
        data=DataConfig(
            data_dir=args.data_dir, horizon=args.horizon, dataset_range=args.dataset_range,
            image_size=args.image_size, n_counties=args.n_counties,
            shard_store=getattr(args, "shard_store", False),
        ),
        model=ModelConfig(
            st_gnn=args.st_gnn, input_channels=args.input_channels,
            output_channels=args.output_channels, compute_dtype=args.compute_dtype,
            d2v_bundle=args.d2v_bundle, remat=args.remat, remat_scope=args.remat_scope,
            pool=args.pool, bn_single_pass=not args.bn_two_pass,
            gwnet=GWNetConfig(**gwnet),
            dcrnn=DCRNNConfig(teacher_forcing=args.teacher_forcing,
                              tf_decay_steps=args.tf_decay_steps),
            gman=GMANConfig(steps=2 * args.horizon),
        ),
        train=TrainConfig(
            epochs=getattr(args, "epochs", 5), batch_size=args.batch_size,
            grad_accum=args.grad_accum, xla_vmem_limit_kib=args.xla_vmem_limit_kib,
            job_id=getattr(args, "job_id", "test"), seed=getattr(args, "seed", 42),
            resume=getattr(args, "resume", False),
            tensorboard=getattr(args, "tensorboard", False),
            profile_dir=getattr(args, "profile_dir", None),
            debug_nans=getattr(args, "debug_nans", False),
        ),
        mesh=MeshConfig(data=getattr(args, "mesh_data", -1),
                        model=getattr(args, "mesh_model", 1),
                        time=getattr(args, "mesh_time", 1)),
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
    if args.coordinator_address:
        from multimodal_outage_tpu_torch.core.mesh import initialize_distributed

        n = initialize_distributed(args.coordinator_address, args.num_processes,
                                   args.process_id, device.type)
        print(f"distributed: {n} global devices")
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
    Date2Vec of --seed's or --weights' variables, not a checkpoint's.
    With a mesh of more than one device, every rank serves its part
    (ServingModel(mesh=)) and rank 0's result is returned."""
    from multimodal_outage_tpu_torch.core.checkpoint import require_checkpoints
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.train.loop import check_supported, resolve_mesh

    if args.checkpoint_path is not None:
        require_checkpoints(args.checkpoint_path)
    cfg = _config(args)
    check_supported(cfg)
    device = resolve_device(args.device)  # fail before any work
    shape = resolve_mesh(cfg, device.type)
    if shape is None:
        return _serve(args, device)
    from multimodal_outage_tpu_torch.parallel import launch

    return launch.run(_serve_rank, shape, device.type, (args,))


def _serve_rank(mesh, args: argparse.Namespace) -> Optional[Dict[str, Any]]:
    from multimodal_outage_tpu_torch.core.mesh import torchrun_env

    out = _serve(args, mesh.device, mesh)
    return out if mesh.is_main or torchrun_env() else None


def _serve(args: argparse.Namespace, device, mesh=None) -> Dict[str, Any]:
    import numpy as np

    from multimodal_outage_tpu_torch.core.checkpoint import restore_variables
    from multimodal_outage_tpu_torch.data.adjacency import config_supports
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import ServingModel, serve_eval
    from multimodal_outage_tpu_torch.train.date2vec_pretrain import install_bundle, load_bundle
    from multimodal_outage_tpu_torch.weights import init_variables, load_npz

    cfg = _config(args)
    store = load_store(args.data_dir)
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
        device=device, mesh=mesh,
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
    if args.save_preds and (mesh is None or mesh.is_main):
        os.makedirs(args.save_preds, exist_ok=True)
        np.save(os.path.join(args.save_preds, "preds.npy"), np.concatenate(preds))
        out["save_preds"] = args.save_preds
    return out


def import_torch_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `import-torch` (JAX cli.py:432-448): a reference checkpoint
    into a checkpoint directory at --out (parity/torch_import.py
    convert_checkpoint). Prints the JAX CLI's line, returns {"out",
    "torch_keys", "leaves"}."""
    from multimodal_outage_tpu_torch.parity.torch_import import convert_checkpoint

    info = convert_checkpoint(_config(args), args.checkpoint, args.out, d2v_pth=args.d2v_pth,
                              strict=not args.no_strict, device=args.device)
    print(f"imported {info['torch_keys']} reference tensors -> "
          f"{info['leaves']} framework leaves at {args.out}")
    return {"out": args.out, **info}


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


def ingest_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `ingest` (JAX cli.py:551-557): prints its line, returns
    {"out_dir", "frames", "dates"}."""
    from multimodal_outage_tpu_torch.data.acquisition import ingest_directory

    frames, dates = ingest_directory(args.raw_dir, args.out_dir, image_size=args.image_size,
                                     device=args.device)
    print(f"packed {args.out_dir}: frames {frames.shape}, {dates.shape[0]} dates")
    return {"out_dir": args.out_dir, "frames": list(frames.shape), "dates": int(dates.shape[0])}


def ingest_monthly_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `ingest-monthly` (JAX cli.py:559-573): prints its line,
    returns {"store_dir", "monthly", "months"}."""
    from multimodal_outage_tpu_torch.data.acquisition import ingest_monthly_directory

    monthly, months = ingest_monthly_directory(args.raw_dir, args.store_dir,
                                               image_size=args.image_size, device=args.device)
    print(f"attached monthly sidecar to {args.store_dir}: "
          f"{monthly.shape} over months {months.tolist()}")
    return {"store_dir": args.store_dir, "monthly": list(monthly.shape),
            "months": months.tolist()}


def download_missing_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `download-missing` (JAX cli.py:574-590): returns JAX's line,
    {"counties", "dates_fetched", "per_county"} (dates fetched and saved
    per county)."""
    from multimodal_outage_tpu_torch.data.acquisition import download_missing_dates

    fetched = download_missing_dates(args.out_dir, margin_days=args.margin_days)
    return {"counties": len(fetched), "dates_fetched": sum(len(v) for v in fetched.values()),
            "per_county": {k: len(v) for k, v in fetched.items()}}


def bench_command(args: argparse.Namespace) -> Dict[str, Any]:
    """Run `bench` (JAX cli.py:594-598): one config of benchmarks.py."""
    from multimodal_outage_tpu_torch.benchmarks import run_benchmark

    return run_benchmark(args.config, steps=args.steps, device=args.device)


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
            "import-torch": import_torch_command, "pretrain-d2v": pretrain_d2v_command,
            "ingest": ingest_command, "ingest-monthly": ingest_monthly_command,
            "download-missing": download_missing_command,
            "bench": bench_command}[args.command](args)


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
