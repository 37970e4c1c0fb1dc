#!/usr/bin/env python3
"""Export a checkpoint directory of the JAX package (orbax, its
core/checkpoint.py: best/ and latest/) into a checkpoint directory of the
PyTorch port (multimodal_outage_tpu_torch/core/checkpoint.py), which the
port's `evaluate`, `serve --checkpoint_path` and `train --resume` read.

    python tools/export_jax_checkpoint.py --checkpoint_path logs/<job>/checkpoints \
        --out <dir> [the model flags the run was trained with]

It imports the JAX package, JAX and orbax, so it runs where they are
installed; the port reads its output without them. It takes the JAX
CLI's common model flags (st_gnn, widths, horizon, image_size,
n_counties, Graph WaveNet branches, ...) and builds the restore template
as the JAX package's convert_checkpoint does (create_train_state on a
zeros batch on the CPU), as shapes only (jax.eval_shape): orbax
restores an optax tuple state without a template as a list or an
index-keyed dict.

Both stores are carried: every step of best/ with its val_loss from
orbax's metrics, and the newest step of latest/ (train --resume's). Each
step's params, batch_stats, step and early-stopping meta carry over as
they are; the optax state chain(scale_by_adam(), scale(-1)) (JAX
train/state.py:28-30) becomes the port's Adam tree {"mu", "nu", "count"}
(train/state.py Adam.state_tree). Prints one JSON object: {"out",
"best_steps", "latest_step", "leaves"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def restore_template(cfg) -> Dict[str, Any]:
    """Shapes and dtypes of the JAX package's checkpoint tree for cfg
    (its train/loop.py ckpt_tree of create_train_state's state), on the
    CPU."""
    import jax
    import jax.numpy as jnp

    from multimodal_outage_tpu.train.loop import build_model, build_supports
    from multimodal_outage_tpu.train.state import create_train_state

    n, t = cfg.data.n_counties, cfg.data.horizon
    s, c = cfg.data.image_size, cfg.model.input_channels
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sample = {"x": jnp.zeros((1, n, t, s, s, c), jnp.dtype(cfg.model.compute_dtype)),
                  "date_feats": jnp.zeros((1, t, 6), jnp.float32)}
        model = build_model(cfg.model, t)
        supports = build_supports(cfg, n)
        state = jax.eval_shape(
            lambda: create_train_state(model, jax.random.PRNGKey(cfg.train.seed), sample,
                                       supports))
    on_cpu = jax.sharding.SingleDeviceSharding(cpu)
    leaf = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=on_cpu)  # noqa: E731
    scalar = lambda dtype: jax.ShapeDtypeStruct((), dtype, sharding=on_cpu)  # noqa: E731
    return jax.tree.map(leaf, {
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": state.opt_state, "step": state.step,
        "meta": {"epoch": scalar(jnp.int32), "best_val": scalar(jnp.float32),
                 "best_epoch": scalar(jnp.int32), "bad_epochs": scalar(jnp.int32)},
    })


def port_tree(restored: Dict[str, Any]) -> Dict[str, Any]:
    """A restored JAX checkpoint tree as the port's checkpoint tree
    (train/loop.py _ckpt_tree): float32 CPU tensors, the Adam moments
    and count, Python numbers for step and meta."""
    import jax
    import numpy as np

    from multimodal_outage_tpu_torch.weights import from_flax

    adam = restored["opt_state"][0]  # optax ScaleByAdamState; [1] is scale's EmptyState
    meta = restored["meta"]
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {
        "params": from_flax(host(restored["params"])),
        "batch_stats": from_flax(host(restored["batch_stats"])),
        "opt_state": {"mu": from_flax(host(adam.mu)), "nu": from_flax(host(adam.nu)),
                      "count": int(adam.count)},
        "step": int(restored["step"]),
        "meta": {"epoch": int(meta["epoch"]), "best_val": float(meta["best_val"]),
                 "best_epoch": int(meta["best_epoch"]), "bad_epochs": int(meta["bad_epochs"])},
    }


def export(cfg, checkpoint_dir: str, out_dir: str) -> Dict[str, Any]:
    """Write the port's checkpoint directory of the JAX run at
    checkpoint_dir (read only) to out_dir; returns what main prints."""
    import orbax.checkpoint as ocp

    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.weights import flatten

    stores = {name: os.path.join(checkpoint_dir, name) for name in ("best", "latest")}
    missing = [d for d in stores.values() if not os.path.isdir(d)]
    if missing:
        raise FileNotFoundError(f"no JAX checkpoint store at {missing}")
    best = ocp.CheckpointManager(stores["best"], options=ocp.CheckpointManagerOptions(
        read_only=True, best_fn=lambda m: m["val_loss"], best_mode="min"))
    latest = ocp.CheckpointManager(stores["latest"],
                                   options=ocp.CheckpointManagerOptions(read_only=True))
    try:
        best_steps, latest_step = sorted(best.all_steps()), latest.latest_step()
        if latest_step is None:
            raise FileNotFoundError(f"no checkpoints in {stores['latest']}")
        args = ocp.args.StandardRestore(restore_template(cfg))
        out = CheckpointManager(out_dir, keep_top_k=max(len(best_steps), 1))
        for step in best_steps:
            # the index is JSON: a finite val_loss (1e30 for an import)
            val = float(best.metrics(step)["val_loss"])
            out.save(step, port_tree(best.restore(step, args=args)), {"val_loss": val})
        tree = port_tree(latest.restore(latest_step, args=args))
        out.save_latest(latest_step, tree)
    finally:
        best.close()
        latest.close()
    leaves = len(flatten(tree["params"])) + len(flatten(tree["batch_stats"]))
    return {"out": out_dir, "best_steps": best_steps, "latest_step": latest_step,
            "leaves": leaves}


def main(argv=None) -> int:
    from multimodal_outage_tpu import cli as jax_cli

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="the JAX run's checkpoint directory (best/ and latest/)")
    p.add_argument("--out", type=str, required=True,
                   help="the port's checkpoint directory to write")
    jax_cli._add_common_model_flags(p)
    args = p.parse_args(argv)
    print(json.dumps(export(jax_cli._build_config(args), args.checkpoint_path, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
