"""The port's parsers against the JAX CLI's (fault C.7 of the ROADMAP):
every option that the JAX parser takes for a command that both packages
have (train, evaluate, serve, import-torch, bench, download-missing) parses
in the port with the JAX default, and the flags map onto the same Config fields as JAX
_build_config maps them. The mesh flags resolve and validate as JAX's
do, before any work: a mesh the devices cannot hold raises JAX's
mesh_from_config errors, and one the config cannot split raises JAX's
_validate_mesh_cfg errors (a mesh that runs: tests/test_torch_port_spmd_fit.py).
"""

import argparse
import dataclasses
import json
import re

import pytest
import torch

from multimodal_outage_tpu import cli as jax_cli
from multimodal_outage_tpu_torch import cli
from multimodal_outage_tpu_torch.core import mesh as mesh_mod
from port_config import jax_fields

COMMANDS = ("train", "evaluate", "serve", "import-torch", "bench", "download-missing")
# the options a command needs to parse at all
REQUIRED = {"train": [], "evaluate": ["--checkpoint_path", "c"],
            "serve": ["--checkpoint_path", "c"],
            "import-torch": ["--checkpoint", "r.ckpt", "--out", "o"], "bench": [],
            "download-missing": ["--out_dir", "o"]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Parser(Exception):
    pass


def _jax_subparsers():
    """The JAX CLI's subparsers by command, taken from the parser its
    main() builds (it parses inside main, so parse_args is stopped)."""
    def stop(self, *a, **kw):
        raise _Parser(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parser) as e:
            jax_cli.main(["train"])
    parser = e.value.args[0]
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _options(parser):
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def _value(action):
    """A value that the port's option takes and that is not its default."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [next(c for c in action.choices if c != action.default)]
    if action.type is float:
        return ["0.25"]
    if action.type is int or action.dest == "grad_accum":
        return ["2"]
    return ["x"]


JAX = _jax_subparsers()


@pytest.mark.parametrize("command", COMMANDS)
def test_every_jax_option_parses_in_the_port_with_its_default(command):
    theirs = _options(JAX[command])
    ours = _options(cli._parser()._subparsers._group_actions[0].choices[command])
    missing = sorted(set(theirs) - set(ours))
    assert not missing, f"{command} rejects JAX's {missing}"
    defaults = cli._parser().parse_args([command, *REQUIRED[command]])
    for flag, action in theirs.items():
        if action.required:
            continue
        # the JAX default, on the JAX dest (serve's --seed is the port's
        # own, the weights' seed; JAX serve has none)
        assert getattr(defaults, action.dest) == action.default, flag
        ns = cli._parser().parse_args([command, *REQUIRED[command], flag,
                                       *_value(ours[flag])])
        assert getattr(ns, action.dest) != action.default, flag


ARGVS = [
    ["train", "--mesh_data", "1", "--mesh_model", "1", "--mesh_time", "1", "--shard_store",
     "--num_processes", "1", "--process_id", "0"],
    ["train", "--mesh_data", "4", "--mesh_time", "2", "--st_gnn", "dcrnn"],
    ["evaluate", "--checkpoint_path", "c", "--mesh_data", "2", "--mesh_model", "3",
     "--teacher_forcing", "0.5", "--tf_decay_steps", "7", "--st_gnn", "dcrnn"],
    ["serve", "--checkpoint_path", "c", "--mesh_time", "2", "--teacher_forcing", "0.25",
     "--tf_decay_steps", "3", "--pool", "pallas", "--bn_two_pass"],
    ["serve", "--checkpoint_path", "c", "--pool", "pairwise", "--mesh_data", "1"],
    ["import-torch", "--checkpoint", "r.ckpt", "--out", "o", "--no_strict", "--d2v_pth", "d",
     "--gwnet_kernel_size", "2", "--no_gcn", "--pool", "pallas", "--teacher_forcing", "0.5",
     "--n_counties", "5", "--image_size", "32", "--horizon", "4", "--compute_dtype",
     "float32", "--remat", "--grad_accum", "auto"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:3]))
def test_new_flags_map_onto_the_config_as_jax_build_config(argv):
    """The port's _config and JAX _build_config, fed the namespace that
    the port and the JAX parser each parse from argv, give the same
    Config field by field: mesh axes, shard_store, the DCRNN teacher
    fields, serve's pool and BatchNorm."""
    ours = cli._config(cli._parser().parse_args(argv))
    theirs = jax_cli._build_config(JAX[argv[0]].parse_args(argv[1:]))
    dump = lambda c: json.dumps(c, default=str, sort_keys=True)  # noqa: E731
    assert dump(jax_fields(ours)) == dump(dataclasses.asdict(theirs))
    assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(theirs.mesh)


SINGLE = ["--data_dir", "/nonexistent", "--device", "cpu"]


@pytest.mark.parametrize("argv,devices,error", [
    (["train", "--mesh_data", "4"], None, "mesh 4x1x1 needs 4 devices, have 1"),
    (["train", "--mesh_model", "2"], None, "1 devices not divisible by model*time=2"),
    (["evaluate", "--mesh_time", "2"], "2", "horizon 7 not divisible by mesh time axis 2"),
    (["serve", "--mesh_data", "2", "--batch_size", "3"], "2",
     "batch_size 3 not divisible by mesh data axis 2"),
    (["serve", "--mesh_model", "2", "--seed", "0", "--pool", "pallas"], "2",
     "pool='pallas' cannot run under a multi-device mesh"),
    (["train", "--mesh_data", "2", "--grad_accum", "2"], "2", "single-device-path feature"),
    (["train", "--coordinator_address", "localhost:1234", "--num_processes", "2",
      "--mesh_data", "4"], "1", "mesh 4x1x1 needs 4 devices, have 2"),
    (["train", "--mesh_time", "3"], "3", "horizon 7 not divisible by mesh time axis 3"),
], ids=lambda a: "_".join(a[:2]) if isinstance(a, list) else str(a))
def test_what_the_port_cannot_run_raises(argv, devices, error, tmp_path, monkeypatch):
    """What the mesh flags cannot run raises JAX's ValueError before
    touching the store or writing a run directory: the mesh needs more
    devices than there are (the virtual-device variable, or the hosts of
    --coordinator_address times each one's), or the batch, the horizon,
    the pool or grad_accum do not fit it (JAX's _validate_mesh_cfg and
    its grad_accum refusal)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mesh_mod, "_MULTIHOST", None)
    if devices is None:
        monkeypatch.delenv(mesh_mod.VIRTUAL_DEVICES_ENV, raising=False)
    else:
        monkeypatch.setenv(mesh_mod.VIRTUAL_DEVICES_ENV, devices)
    if argv[0] in ("evaluate", "serve") and "--seed" not in argv:
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        (ckpt / "x").write_text("")
        argv = argv + ["--checkpoint_path", str(ckpt)]
    with pytest.raises(ValueError, match=re.escape(error)):
        cli.run(argv + SINGLE)
    assert not (tmp_path / "logs").exists()


def test_one_device_mesh_flags_run(tiny_store_dir, tmp_path, monkeypatch):
    """The one-device settings of the JAX command line run as without
    them: a train run with --mesh_data 1 --shard_store --num_processes 1
    --process_id 0 equals the same run without."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--data_dir", tiny_store_dir, "--dataset_range", "6", "--horizon", "3",
            "--image_size", "16", "--batch_size", "2", "--epochs", "1", "--compute_dtype",
            "float32", "--device", "cpu"]
    plain = cli.run(["train", "--job_id", "plain", *tiny])
    flags = cli.run(["train", "--job_id", "flags", "--mesh_data", "1", "--mesh_model", "1",
                     "--mesh_time", "1", "--shard_store", "--num_processes", "1",
                     "--process_id", "0", *tiny])
    assert flags == plain


def test_download_missing_prints_jaxs_line(monkeypatch, capsys):
    """`download-missing --out_dir d --margin_days 5` with the download
    stubbed alike in both packages: the same call and the same one line,
    {"counties", "dates_fetched", "per_county"}; no --device."""
    import datetime

    from multimodal_outage_tpu.data import acquisition as jax_acq
    from multimodal_outage_tpu_torch.data import acquisition as acq

    d = datetime.date
    fetched = {"alachua": [d(2022, 9, 26), d(2022, 9, 27)], "baker": [], "bay": [d(2018, 10, 1)]}
    calls = []

    def fake(out_dir, margin_days=90):
        calls.append((out_dir, margin_days))
        return {k: list(v) for k, v in fetched.items()}

    monkeypatch.setattr(jax_acq, "download_missing_dates", fake)
    monkeypatch.setattr(acq, "download_missing_dates", fake)
    argv = ["download-missing", "--out_dir", "d", "--margin_days", "5"]
    lines = []
    for main in (jax_cli.main, cli.main):
        assert main(argv) == 0
        lines.append(capsys.readouterr().out.strip().splitlines())
    assert lines[1] == lines[0] and len(lines[0]) == 1
    assert json.loads(lines[0][0]) == {"counties": 3, "dates_fetched": 3,
                                       "per_county": {"alachua": 2, "baker": 0, "bay": 1}}
    assert calls == [("d", 5), ("d", 5)]
    assert "--device" not in _options(cli._parser()._subparsers._group_actions[0]
                                      .choices["download-missing"])
