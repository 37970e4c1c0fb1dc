"""The port's ingest on the CPU (data/acquisition.py, `ingest` and
`ingest-monthly`), held against the JAX package's on the same raw trees:
.npy and pickled rasters of mixed non-square shapes (downscaled, upscaled,
and one axis each way), fill sentinels at native resolution, and a date
that one county lacks.

Tolerance: dates, counties and month keys are held to equality; frames
to atol 1e-4 / rtol 1e-5 (values up to ~100). Both packages resize with
the same antialiased bilinear filter (jax.image.resize and F.interpolate
with antialias=True) and differ only in the order they sum the taps.
"""

import datetime
import pickle

import numpy as np
import pytest
import torch

from multimodal_outage_tpu.data import acquisition as jax_acq
from multimodal_outage_tpu.data.store import load_store as jax_load_store
from multimodal_outage_tpu_torch import cli
from multimodal_outage_tpu_torch.core.config import NTL_FILL_SENTINEL
from multimodal_outage_tpu_torch.data import acquisition as acq
from multimodal_outage_tpu_torch.data.pipeline import resize_bilinear
from multimodal_outage_tpu_torch.data.stats import compute_mean_std
from multimodal_outage_tpu_torch.data.store import load_store

ATOL, RTOL = 1e-4, 1e-5
SIZE = 16
# per county: its raster shape (real rasters keep one bbox per county)
# and whether its days are pickled xarray-like objects
COUNTIES = {"alachua": ((23, 31), False), "baker": ((9, 13), True),
            "bay": ((40, 11), False), "dade": ((16, 16), False)}
DATES = [datetime.date(2018, 10, d) for d in range(7, 13)]
MONTHS = [(2018, 6), (2018, 7), (2018, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Variable:
    """Stands in for an xarray DataArray: the reference pickles a Dataset
    and reads data["Gap_Filled_DNB_BRDF-Corrected_NTL"].values."""

    def __init__(self, values):
        self.values = values


def _raster(rng, shape):
    arr = rng.gamma(2.0, 8.0, shape).astype(np.float32)
    flat = arr.reshape(-1)
    flat[rng.choice(flat.size, size=max(1, flat.size // 25), replace=False)] = NTL_FILL_SENTINEL
    return arr


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """{county}/{Y_m_d}.npy|pickle daily rasters and monthly_{Y}_{M}.npy
    composites; one extra date that 'bay' lacks, one month 'dade' lacks."""
    raw = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(5)
    extra_day, extra_month = datetime.date(2018, 10, 13), (2018, 9)
    for county, (shape, pickled) in COUNTIES.items():
        cdir = raw / county
        cdir.mkdir()
        days = DATES + ([extra_day] if county != "bay" else [])
        for d in days:
            arr = _raster(rng, shape)
            stem = f"{d.year}_{d.month}_{d.day}"
            if pickled:
                with open(cdir / f"{stem}.pickle", "wb") as f:
                    pickle.dump({acq.NTL_VARIABLE: _Variable(arr)}, f)
            else:
                np.save(cdir / f"{stem}.npy", arr)
        for y, m in MONTHS + ([extra_month] if county != "dade" else []):
            np.save(cdir / f"monthly_{y}_{m}.npy", _raster(rng, shape))
    (raw / "notes.txt").write_text("not a county")
    return str(raw)


def test_date_helpers_match_jax(tmp_path):
    assert acq.hurricane_date_ranges(margin_days=8) == jax_acq.hurricane_date_ranges(
        margin_days=8)
    for name in ("2022_9_28.npy", "2022_09_28.pickle", "2022_9_28.pkl", "monthly_2018_6.npy",
                 "2022_9_28.txt"):
        assert acq.parse_date_filename(name) == jax_acq.parse_date_filename(name)
    (tmp_path / "2018_10_9.npy").touch()
    (tmp_path / "2018_10_7.pickle").touch()
    (tmp_path / "readme").touch()
    assert acq.find_available_dates(str(tmp_path)) == jax_acq.find_available_dates(
        str(tmp_path))
    have = [datetime.date(2018, 10, 8), datetime.date(2018, 10, 10)]
    start, end = datetime.date(2018, 10, 7), datetime.date(2018, 10, 11)
    assert acq.find_missing_dates(have, start, end) == jax_acq.find_missing_dates(
        have, start, end)
    per = {"a": DATES[:4], "b": DATES[2:]}
    assert acq.common_dates(per) == jax_acq.common_dates(per) == DATES[2:4]
    assert acq.common_dates({}) == []


@pytest.mark.parametrize("shape", [(30, 30), (9, 12), (40, 11), (13, 27), (16, 16)],
                         ids=["down", "up", "down-up", "up-down", "same"])
def test_resize_matches_jax(shape):
    """The port's one resize against the JAX ingest's jax.image.resize:
    square and not, each axis shrinking or growing."""
    arr = np.random.default_rng(2).gamma(2.0, 8.0, shape).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(arr), SIZE).numpy()
    np.testing.assert_allclose(got, jax_acq._resize_to(arr, SIZE), atol=ATOL, rtol=RTOL)


def test_ingest_directory_matches_jax(raw_tree, tmp_path):
    want_frames, want_dates = jax_acq.ingest_directory(raw_tree, str(tmp_path / "jax"),
                                                       image_size=SIZE)
    frames, dates = acq.ingest_directory(raw_tree, str(tmp_path / "port"), image_size=SIZE,
                                         device="cpu")
    np.testing.assert_array_equal(dates, want_dates)
    assert [tuple(d) for d in dates] == [(d.year, d.month, d.day) for d in DATES]
    assert frames.dtype == np.float32 and frames.shape == (len(DATES), 4, SIZE, SIZE)
    np.testing.assert_allclose(frames, want_frames, atol=ATOL, rtol=RTOL)
    # the sentinel went before the resize: nothing near 6553.5 survives
    assert frames.max() < 1000
    store, jstore = load_store(str(tmp_path / "port")), jax_load_store(str(tmp_path / "jax"))
    assert store.county_names == jstore.county_names == sorted(COUNTIES)
    np.testing.assert_array_equal(store.frames, frames)
    np.testing.assert_array_equal(store.dates, jstore.dates)


def test_ingest_monthly_directory_matches_jax(raw_tree, tmp_path):
    for name in ("jax", "port"):
        acq.ingest_directory(raw_tree, str(tmp_path / name), image_size=SIZE, device="cpu")
    want, want_months = jax_acq.ingest_monthly_directory(raw_tree, str(tmp_path / "jax"),
                                                         image_size=SIZE)
    got, months = acq.ingest_monthly_directory(raw_tree, str(tmp_path / "port"),
                                               image_size=SIZE, device="cpu")
    np.testing.assert_array_equal(months, want_months)
    assert [tuple(m) for m in months] == MONTHS
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert got.max() < 1000
    store = load_store(str(tmp_path / "port"))
    np.testing.assert_array_equal(store.monthly, got)
    np.testing.assert_array_equal(store.monthly_months, months)


def test_ingest_raises_without_common_dates(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with pytest.raises(ValueError, match="no common dates"):
        acq.ingest_directory(str(tmp_path), str(tmp_path / "out"), device="cpu")
    with pytest.raises(ValueError, match="no common monthly"):
        acq.ingest_monthly_directory(str(tmp_path), str(tmp_path), counties=["a", "b"],
                                     device="cpu")


def test_cli_ingest_and_ingest_monthly(raw_tree, tmp_path, capsys):
    out_dir = str(tmp_path / "store")
    got = cli.run(["ingest", "--raw_dir", raw_tree, "--out_dir", out_dir, "--image_size",
                   str(SIZE), "--device", "cpu"])
    assert got == {"out_dir": out_dir, "frames": [len(DATES), 4, SIZE, SIZE],
                   "dates": len(DATES)}
    assert f"packed {out_dir}: frames ({len(DATES)}, 4, {SIZE}, {SIZE}), {len(DATES)} dates" \
        in capsys.readouterr().out
    got = cli.run(["ingest-monthly", "--raw_dir", raw_tree, "--store_dir", out_dir,
                   "--image_size", str(SIZE), "--device", "cpu"])
    assert got == {"store_dir": out_dir, "monthly": [3, 4, SIZE, SIZE],
                   "months": [list(m) for m in MONTHS]}
    assert "attached monthly sidecar to" in capsys.readouterr().out
    # the tree covers one storm; `stats` sweeps all three
    mean, std = compute_mean_std(load_store(out_dir), {"michael": DATES[3]}, dataset_range=2)
    assert np.isfinite(mean) and std > 0


@pytest.mark.parametrize("command", ["ingest", "ingest-monthly"])
def test_cli_ingest_without_device_needs_a_card(command, raw_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    dest = "--out_dir" if command == "ingest" else "--store_dir"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([command, "--raw_dir", raw_tree, dest, str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()
