"""The port's Black Marble downloads (data/acquisition.py) against the JAX
package's, offline: blackmarble.raster.bm_raster and geopandas are stubs
(as tests/test_acquisition.py builds them), the county geometries and,
where a test needs overlapping windows, the hurricane date ranges are
patched alike in both modules. Each download runs in both packages into
a directory of its own; the return values, the requests (product, dates,
variable, bearer token) and the files written must be equal, the files
byte for byte, and so must the errors raised before any request.
"""

import datetime
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from multimodal_outage_tpu.data import acquisition as jax_acq
from multimodal_outage_tpu_torch.data import acquisition as acq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "test-token"


class _Values:
    def __init__(self, values):
        self.values = values


class _Raster:
    """The xarray.Dataset surface that the downloads read:
    raster["time"].values and raster.sel(time=<Y-m-d>)[variable].values."""

    def __init__(self, days, variable):
        self._days, self._variable = days, variable

    def __getitem__(self, key):
        assert key == "time"
        return _Values(np.array(list(self._days), dtype="datetime64[D]"))

    def sel(self, time):
        return {self._variable: _Values(self._days[time])}


class _County:
    """A county's geometry as bm_raster receives it."""

    def __init__(self, name, seed):
        self.name, self.seed = name, seed


COUNTIES = {"alachua": _County("alachua", 1), "miami-dade": _County("miami-dade", 2),
            "st._johns": _County("st._johns", 3)}


def _no_granule(product_id, day):
    """Days that upstream has no daily granule for (about one in seven)."""
    return product_id == "VNP46A2" and day.toordinal() % 7 == 3


@pytest.fixture()
def stubs(monkeypatch):
    """Stub blackmarble and geopandas modules, the token, and the county
    geometries of both packages. Returns the request log."""
    pd = pytest.importorskip("pandas")
    log = []

    def bm_raster(gdf, product_id, date_range, bearer, variable):
        assert isinstance(date_range, pd.DatetimeIndex)
        days = [ts.date() for ts in date_range]
        log.append((gdf.name, product_id, [d.isoformat() for d in days], variable, bearer))
        values = {}
        for d in days:
            if not _no_granule(product_id, d):
                rng = np.random.default_rng([gdf.seed, d.toordinal(), len(product_id)])
                values[d.isoformat()] = rng.normal(size=(3, 5)) * 10  # float64: saved as f32
        return _Raster(values, variable)

    bm = types.ModuleType("blackmarble")
    bm_r = types.ModuleType("blackmarble.raster")
    bm_r.bm_raster = bm_raster
    bm.raster = bm_r
    monkeypatch.setitem(sys.modules, "blackmarble", bm)
    monkeypatch.setitem(sys.modules, "blackmarble.raster", bm_r)
    monkeypatch.setitem(sys.modules, "geopandas", types.ModuleType("geopandas"))
    monkeypatch.setenv("NASA_BEARER_TOKEN", TOKEN)
    for mod in (jax_acq, acq):
        monkeypatch.setattr(mod, "load_florida_county_geometries", lambda: dict(COUNTIES))
    return log


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _run_both(stubs, tmp_path, call, prefill=None):
    """call(module, out_dir) in the JAX package then the port, each into
    its own directory (prefilled alike by prefill(out_dir)); returns
    both results, request logs and file trees."""
    got = {}
    for name, mod in (("jax", jax_acq), ("port", acq)):
        out = tmp_path / name
        out.mkdir()
        if prefill:
            prefill(str(out))
        del stubs[:]
        result = call(mod, str(out))
        got[name] = (result, list(stubs), _files(out))
    return got["jax"], got["port"]


def _assert_same(theirs, ours):
    (t_res, t_log, t_files), (o_res, o_log, o_files) = theirs, ours
    assert o_res == t_res
    assert o_log == t_log and o_log
    assert sorted(o_files) == sorted(t_files)
    for path, data in t_files.items():
        assert o_files[path] == data, path


# two overlapping windows (2022-09-26..10-02 and 09-30..10-06 share four
# days) and one apart
OVERLAPPING = {"a": (datetime.date(2022, 9, 26), datetime.date(2022, 10, 2)),
               "b": (datetime.date(2022, 9, 30), datetime.date(2022, 10, 6)),
               "c": (datetime.date(2023, 8, 28), datetime.date(2023, 9, 1))}


@pytest.mark.parametrize("filled", [0.0, 0.5])
def test_download_missing_dates_matches_jax(stubs, tmp_path, monkeypatch, filled):
    """The gaps of overlapping windows fetched once each, one request per
    contiguous run, days without a granule skipped and not counted; a
    county directory partly filled from a numpy seed (with a file that is
    not a day) is only topped up."""
    for mod in (jax_acq, acq):
        monkeypatch.setattr(mod, "hurricane_date_ranges", lambda h, m: dict(OVERLAPPING))
    days = sorted({start + datetime.timedelta(days=i) for start, end in OVERLAPPING.values()
                   for i in range((end - start).days + 1)})

    def prefill(out):
        rng = np.random.default_rng(7)
        for county in COUNTIES:
            os.makedirs(os.path.join(out, county))
            np.save(os.path.join(out, county, "notes.npy"), np.zeros(1))
            for d in days:
                if rng.random() < filled:
                    np.save(os.path.join(out, county, f"{d.year}_{d.month}_{d.day}.npy"),
                            rng.normal(size=(3, 5)).astype(np.float32))

    theirs, ours = _run_both(stubs, tmp_path, lambda m, out: m.download_missing_dates(out),
                             prefill)
    _assert_same(theirs, ours)
    fetched, log, _ = ours
    assert set(fetched) == set(COUNTIES)
    for county, saved in fetched.items():
        asked = [d for name, _, ds, _, _ in log if name == county for d in ds]
        assert len(asked) == len(set(asked))  # the overlap is asked for once
        assert saved == sorted(saved) and all(not _no_granule("VNP46A2", d) for d in saved)
    assert any(_no_granule("VNP46A2", datetime.date.fromisoformat(d))
               for _, _, ds, _, _ in log for d in ds)
    if filled:  # topped up: fewer requests than the windows' days
        assert sum(len(v) for v in fetched.values()) < len(COUNTIES) * len(days)


def test_download_county_rasters_matches_jax(stubs, tmp_path):
    """Every (county, hurricane) window at margin 3 for two storms, the
    JAX defaults of product and variable; days without a granule are
    skipped, not raised on."""
    hurricanes = {"michael": datetime.date(2018, 10, 10), "ian": datetime.date(2022, 9, 28)}
    theirs, ours = _run_both(stubs, tmp_path, lambda m, out: m.download_county_rasters(
        out, hurricanes=hurricanes, margin_days=3))
    _assert_same(theirs, ours)
    result, log, files = ours
    assert result is None
    assert {(p, v, b) for _, p, _, v, b in log} == {("VNP46A2", acq.NTL_VARIABLE, TOKEN)}
    assert len(log) == len(COUNTIES) * len(hurricanes)
    assert all(np.load(os.path.join(tmp_path, "port", p)).dtype == np.float32 for p in files)


def test_download_monthly_composites_matches_jax(stubs, tmp_path):
    """RISK_MONTHS of the default hurricanes' years, one request each."""
    theirs, ours = _run_both(stubs, tmp_path,
                             lambda m, out: m.download_monthly_composites(out))
    _assert_same(theirs, ours)
    _, log, files = ours
    assert {(p, v) for _, p, _, v, _ in log} == {("VNP46A3", "NearNadir_Composite_Snow_Free")}
    assert "alachua/monthly_2023_4.npy" in files and len(files) == len(COUNTIES) * 9


def test_download_annual_composites_matches_jax(stubs, tmp_path):
    theirs, ours = _run_both(stubs, tmp_path,
                             lambda m, out: m.download_annual_composites(out, [2018, 2022]))
    _assert_same(theirs, ours)
    _, log, files = ours
    assert {(p, tuple(ds)) for _, p, ds, _, _ in log} == {
        ("VNP46A4", ("2018-01-01",)), ("VNP46A4", ("2022-01-01",))}
    assert sorted(files) == sorted(f"{c}/annual_{y}.npy" for c in COUNTIES for y in (2018, 2022))


DOWNLOADS = {
    "download_missing_dates": lambda m, out: m.download_missing_dates(out),
    "download_county_rasters": lambda m, out: m.download_county_rasters(out),
    "download_monthly_composites": lambda m, out: m.download_monthly_composites(out),
    "download_annual_composites": lambda m, out: m.download_annual_composites(out, [2022]),
}


def _error(call, mod, out):
    with pytest.raises(RuntimeError) as e:
        call(mod, out)
    return str(e.value)


@pytest.mark.parametrize("name", sorted(DOWNLOADS))
@pytest.mark.parametrize("missing", ["token", "blackmarble", "geopandas"])
def test_download_errors_match_jax(name, missing, monkeypatch, tmp_path):
    """The token is checked first, then blackmarblepy and geopandas
    (annual needs no geopandas), each with JAX's RuntimeError message,
    before anything is written."""
    monkeypatch.setenv("NASA_BEARER_TOKEN", TOKEN)
    bm = types.ModuleType("blackmarble.raster")
    bm.bm_raster = lambda *a, **kw: pytest.fail("no request may be made")
    monkeypatch.setitem(sys.modules, "blackmarble", types.ModuleType("blackmarble"))
    monkeypatch.setitem(sys.modules, "blackmarble.raster", bm)
    monkeypatch.setitem(sys.modules, "geopandas", types.ModuleType("geopandas"))
    if missing == "token":
        monkeypatch.delenv("NASA_BEARER_TOKEN")
    else:
        monkeypatch.setitem(sys.modules, f"{missing}.raster" if missing == "blackmarble"
                            else missing, None)
    call = DOWNLOADS[name]
    if missing == "geopandas" and name == "download_annual_composites":
        # past the imports: the geometries are the next call
        for mod in (jax_acq, acq):
            monkeypatch.setattr(mod, "load_florida_county_geometries",
                                lambda: (_ for _ in ()).throw(RuntimeError("geometries")))
    theirs = _error(call, jax_acq, str(tmp_path / "jax"))
    assert _error(call, acq, str(tmp_path / "port")) == theirs
    assert ("NASA_BEARER_TOKEN" in theirs) == (missing == "token")
    assert not os.path.exists(tmp_path / "port")


@pytest.mark.parametrize("seed", range(4))
def test_contiguous_runs_match_jax(seed):
    rng = np.random.default_rng(seed)
    start = datetime.date(2018, 1, 1)
    dates = [start + datetime.timedelta(days=int(i))
             for i in rng.choice(60, size=int(rng.integers(0, 40)), replace=False)]
    ours = acq._contiguous_runs(dates)
    assert ours == jax_acq._contiguous_runs(dates)
    assert sum((b - a).days + 1 for a, b in ours) == len(dates)


def test_county_geometries_match_jax(monkeypatch):
    """GADM 4.1's URL, the Florida rows only, NAME_2 lower-cased with
    underscores for spaces, each a GeoDataFrame of its bounding box in the
    source's CRS."""
    pd = pytest.importorskip("pandas")

    class Frame(pd.DataFrame):
        _metadata = ["crs"]

        @property
        def _constructor(self):
            return Frame

    class Shape:
        def __init__(self, i):
            self.envelope = ("envelope", i)

    rows = [("Florida", "Miami-Dade"), ("Georgia", "Baker"), ("Florida", "Palm Beach"),
            ("Florida", "St. Johns")]
    urls = []

    def read_file(url):
        urls.append(url)
        frame = Frame({"NAME_1": [a for a, _ in rows], "NAME_2": [b for _, b in rows],
                       "geometry": [Shape(i) for i in range(len(rows))]})
        frame.crs = "EPSG:4326"
        return frame

    gpd = types.ModuleType("geopandas")
    gpd.read_file = read_file
    gpd.GeoDataFrame = lambda geometry, crs: {"geometry": geometry, "crs": crs}
    monkeypatch.setitem(sys.modules, "geopandas", gpd)
    theirs, ours = jax_acq.load_florida_county_geometries(), acq.load_florida_county_geometries()
    assert ours == theirs
    assert list(ours) == ["miami-dade", "palm_beach", "st._johns"]
    assert ours["palm_beach"] == {"geometry": [("envelope", 2)], "crs": "EPSG:4326"}
    assert urls[0] == urls[1] == acq.GADM_USA_COUNTIES_URL

    monkeypatch.setitem(sys.modules, "geopandas", None)
    with pytest.raises(RuntimeError) as theirs:
        jax_acq.load_florida_county_geometries()
    with pytest.raises(RuntimeError) as ours:
        acq.load_florida_county_geometries()
    assert str(ours.value) == str(theirs.value)


def test_module_imports_without_the_extras():
    """A fresh interpreter where pandas, geopandas and blackmarble cannot
    be imported (as on the card's machine) imports the module, and a
    download then raises JAX's error naming the extras."""
    code = (
        "import os, sys\n"
        "for m in ('pandas', 'geopandas', 'blackmarble', 'blackmarble.raster'):\n"
        "    sys.modules[m] = None\n"
        "from multimodal_outage_tpu_torch.data import acquisition as acq\n"
        "os.environ['NASA_BEARER_TOKEN'] = 't'\n"
        "try:\n"
        "    acq.download_missing_dates('unused')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RAISED blackmarblepy/geopandas are required for downloads" in out.stdout
    assert not os.path.exists(os.path.join(REPO, "unused"))
