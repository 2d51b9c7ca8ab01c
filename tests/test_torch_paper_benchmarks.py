"""The port's paper benchmarks, harness and examples
(``repro_torch.benchmarks.{table2,table3,table4,fig10,fig16,run}``,
``repro_torch.examples.{quickstart,sweet_spot_explorer}``) against the JAX
package's ``benchmarks/`` and ``examples/``, on the CPU.

Table 3, the A100 rows of Table 4 and Figure 10, Table 2's analytic columns
and the A100 surfaces of the sweet-spot explorer equal JAX's output string
for string; the H100 rows (data-sheet figures) equal closed forms of the
port's ``perfmodel``; no TPU row is left.  ``fig16 --device cpu`` gives
MODEL columns from ``perf_vector`` / ``perf_matrix`` and positive ``cpu_``
columns; the harness exits 0 and lists every module, and exits 1 with the
others still reported when one module raises; the quickstart's backends are
JAX's, each within its tolerance; and no module of the port imports ``jax``
or ``repro``.  The JAX side is skipped where JAX is absent."""
import contextlib
import importlib.util
import io
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import fig16, run as bench_run, table2, traffic
from repro_torch.core import perfmodel as pm
from repro_torch.core.selector import transition_depth
from repro_torch.examples import quickstart, sweet_spot_explorer
from repro_torch.kernels import registered_backends
from repro_torch.kernels.common import BAND_N
from repro_torch.stencil import StencilSpec
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = ("table2", "table3", "table4", "fig10", "fig16", "halo", "scaling",
           "traffic")


def _jax_file(rel: str):
    """A module of the JAX package's ``benchmarks/`` or ``examples/``,
    loaded from its file (JAX side)."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """One quick CPU run of the port's harness: (exit code, its lines by
    module prefix, the manifest)."""
    manifest = tmp_path_factory.mktemp("bench") / "manifest.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(["--quick", "--device", "cpu",
                             "--manifest", str(manifest)])
    lines = {}
    for line in buf.getvalue().splitlines():
        lines.setdefault(line.split(".", 1)[0], []).append(line)
    return rc, lines, json.loads(manifest.read_text())


@pytest.fixture(scope="module")
def jax_tables():
    """The JAX package's table2/table3/table4/fig10 lines."""
    return {name: _jax_file(f"benchmarks/{name}.py").run()
            for name in ("table2", "table3", "table4", "fig10")}


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------
def test_harness_runs_every_module(harness):
    rc, lines, manifest = harness
    assert rc == 0
    assert manifest["succeeded"] == list(MODULES) and manifest["failed"] == []
    assert manifest["device"] == "cpu" and manifest["quick"] is True
    for name in MODULES:
        assert lines[name][0].startswith(f"{name}.")       # its header first
    totals = [ln for ln in lines["bench"] if ln.endswith(",us_wall")]
    assert [ln.split(".")[1] for ln in totals] == list(MODULES)
    assert any(ln.startswith("bench.plan_cache,") for ln in lines["bench"])
    assert lines["scaling"][0].startswith("scaling.arch,cell,dom_single_ms")
    assert lines["traffic"][0].startswith("traffic.case,tile,")


def _boom(*args, **kwargs):
    raise RuntimeError("module made to fail")


@pytest.mark.parametrize("broken", ["table3", "fig16"])
def test_harness_exits_nonzero_on_a_failed_module(broken, monkeypatch, tmp_path,
                                                  capsys):
    """JAX's harness exits 0 whatever failed; the port's reports every
    module and exits 1.  (The slow modules are stubbed: only the exit and
    the report are under test.)"""
    monkeypatch.setattr(table2, "run", lambda device: ["table2.stub"])
    monkeypatch.setattr(fig16, "run", lambda device, quick: ["fig16.stub"])
    monkeypatch.setattr(traffic, "run", lambda device, quick: ["traffic.stub"])
    mod = {"table3": "repro_torch.benchmarks.table3",
           "fig16": "repro_torch.benchmarks.fig16"}[broken]
    monkeypatch.setattr(f"{mod}.run", _boom)
    manifest = tmp_path / "m.json"
    rc = bench_run.main(["--device", "cpu", "--manifest", str(manifest)])
    assert rc == 1
    m = json.loads(manifest.read_text())
    assert m["failed"] == [broken]
    assert m["succeeded"] == [n for n in MODULES if n != broken]
    out = capsys.readouterr().out
    assert f"bench.{broken}.FAILED,0,module made to fail" in out
    assert "halo.Box-3D1R" in out                 # the modules after it ran


def test_harness_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    assert bench_run.main(["--manifest", str(tmp_path / "m.json")]) == 1
    assert not (tmp_path / "m.json").exists()


# ---------------------------------------------------------------------------
# The tables against JAX
# ---------------------------------------------------------------------------
def test_table3_equals_jax(harness, jax_tables):
    assert harness[1]["table3"] == jax_tables["table3"]


def test_table4_a100_rows_equal_jax(harness, jax_tables):
    port, jax = harness[1]["table4"], jax_tables["table4"]
    assert port[:3] == jax[:3]                       # header and the A100 rows
    assert not any("v5e" in ln or "TPU" in ln for ln in port)


def test_table4_h100_rows_closed_form(harness):
    """Dense against 2:4-sparse TF32 tensor cores on the H100 data sheet,
    Box-2D1R, t=7, D=4, S = (2R+1)/(BAND_N+2R) at R=7."""
    hw = pm.H100_SXM_DATASHEET
    spec = StencilSpec("box", 2, 1)
    w = pm.StencilWorkload(spec, 7, 4)
    s = 15 / (BAND_N + 14)
    alpha = w.alpha
    i_mat = w.intensity_matrix(s)
    assert i_mat == pytest.approx(7 * alpha / s * spec.num_points / 4)
    rows = []
    for name, peak in (("dense", hw.p_matrix), ("sparse", hw.p_sparse)):
        actual = s / alpha * min(peak, hw.bandwidth * i_mat)
        bound = "compute" if peak <= hw.bandwidth * i_mat else "memory"
        rows.append((name, peak / hw.bandwidth, bound, actual))
    dense_actual = rows[0][3]
    expect = [f"table4.H100-{n}-TC,{i_mat:.0f},{ridge:.0f},{bound},"
              f"{actual/1e12:.3f},{actual/dense_actual:.2f}x"
              for n, ridge, bound, actual in rows]
    assert harness[1]["table4"][3:] == expect


def test_fig10_a100_rows_equal_jax(harness, jax_tables):
    port, jax = harness[1]["fig10"], jax_tables["fig10"]
    n_a100 = 1 + sum("A100" in ln for ln in jax)
    assert port[:n_a100] == jax[:n_a100]
    assert not any("TPU" in ln for ln in port)


def test_fig10_h100_rows_closed_form(harness):
    """t* is the least t whose vector intensity t*K/D reaches the data
    sheet's vector ridge (67e12 / 3.35e12 = 20 FLOP/B)."""
    from repro_torch.benchmarks import fig10

    hw = pm.H100_SXM_DATASHEET
    ridge = hw.p_vector / hw.bandwidth
    h100 = [ln for ln in harness[1]["fig10"] if ",H100," in ln]
    assert len(h100) == len(fig10.CONFIGS)
    for line, (name, D) in zip(h100, fig10.CONFIGS):
        spec = StencilSpec.from_name(name)
        def intensity(t):
            return pm.StencilWorkload(spec, t, D).intensity_vector()
        tstar = next((t for t in range(1, 65) if intensity(t) >= ridge), None)
        assert tstar == transition_depth(spec, D, hw, t_max=64)
        b = ["compute" if intensity(t) >= ridge else "memory" for t in (1, 8)]
        assert line == (f"fig10.{name},{'f32' if D == 4 else 'f64'},H100,"
                        f"{tstar},{b[0]},{b[1]}")


def test_table2_analytic_columns_equal_jax(harness, jax_tables):
    """Every column but C_measured and dC% (the counters differ on the
    fused vector rows; tests/test_torch_hlo_cost.py holds them)."""
    def analytic(line):
        f = line.split(",")
        return f[:5] + f[7:]
    port, jax = harness[1]["table2"], jax_tables["table2"]
    assert [analytic(ln) for ln in port] == [analytic(ln) for ln in jax]
    for p, j in zip(port[1:], jax[1:]):
        if ".vector(" not in p or ",1,f" in p:     # all but the fused vector rows
            assert p == j


def test_table2_counts_the_same_on_any_device():
    """The counts depend on the ops, not the data: the CPU rows twice."""
    a, b = table2.rows("cpu"), table2.rows("cpu")
    assert [r["c_meas"] for r in a] == [r["c_meas"] for r in b]


# ---------------------------------------------------------------------------
# Figure 16
# ---------------------------------------------------------------------------
def test_fig16_cpu_columns(harness):
    lines = harness[1]["fig16"]
    head = lines[0].split(",")
    assert head[6:11] == ["cpu_vec_us", "cpu_vec_GSt/s", "cpu_mat_us",
                          "cpu_mat_GSt/s", "cpu_winner"]
    assert head[-1] == "device"
    hw = pm.H100_SXM_DATASHEET
    assert len(lines) == 1 + len(fig16.PATTERNS)
    for line, pattern in zip(lines[1:], fig16.PATTERNS):
        f = line.split(",")
        spec = StencilSpec.from_name(pattern)
        t = 4 if spec.dim == 2 else 2
        w = pm.StencilWorkload(spec, t, 4)
        gv = pm.perf_vector(w, hw).stencil_throughput(w) * t / 1e9
        s = pm.sparsity_banded(spec.radius * t, BAND_N)
        gm = pm.perf_matrix(w, hw, s).stencil_throughput(w) * t / 1e9
        assert f[:6] == [f"fig16.{pattern}", str(t), f"{gv:.1f}", f"{gm:.1f}",
                         "vector" if gv >= gm else "matrix",
                         "256x256" if spec.dim == 2 else "48x48x48"]
        us_v, rate_v, us_m, rate_m = map(float, f[6:10])
        assert min(us_v, rate_v, us_m, rate_m) > 0
        n = 256 ** 2 if spec.dim == 2 else 48 ** 3
        assert rate_v == pytest.approx(n * t / us_v / 1e3, rel=1e-3)
        assert f[10] == ("vector" if us_v <= us_m else "matrix")
        assert f[11] == "cpu"


def test_fig16_prints_a_refusal_and_falls_back_to_nothing(monkeypatch):
    """A regime the port refuses prints the refusal in its column; the
    other path is still timed, and nothing runs in the refused one's place."""
    from repro_torch.kernels import plan as tplan

    real = tplan.stencil_plan
    built = []

    def refusing(w, shape, dtype, t, backend=None, **kw):
        built.append(backend)
        if backend == "fused_matmul":
            raise ValueError("banded needs a contraction depth of 72, over 64")
        return real(w, shape, dtype, t, backend=backend, **kw)

    monkeypatch.setattr(fig16, "stencil_plan", refusing)
    monkeypatch.setattr(fig16, "PATTERNS", ["Box-2D1R"])
    lines = fig16.run("cpu", quick=True)
    f = lines[1].split(",")
    assert f[8] == "refused: banded needs a contraction depth of 72; over 64"
    assert f[9] == "-" and f[10] == "vector" and float(f[6]) > 0
    assert built == ["reference", "fused_direct", "fused_matmul"]


@pytest.mark.parametrize("backend", registered_backends())
def test_oracle_tolerance_is_perf_md(backend):
    """PERF.md §2: tap-sum 1e-5 t max|x|, banded t 2^-10 sum|w| max|x|,
    by the backend's unit (the foils and legacy backends as their kernels)."""
    from repro_torch.kernels.ref import oracle_tolerance

    w = np.ones((3, 3)) / 9
    x = torch.full((4, 4), -2.0)
    banded = "matmul" in backend
    expect = 4 * 2 ** -10 * 2 if banded else 1e-5 * 4 * 2
    assert oracle_tolerance(backend, 4, w, x) == pytest.approx(expect)


def test_fig16_fails_a_plan_outside_its_tolerance(monkeypatch):
    monkeypatch.setattr(fig16, "PATTERNS", ["Star-2D1R"])
    monkeypatch.setattr(fig16, "oracle_tolerance", lambda *a: -1.0)
    with pytest.raises(RuntimeError, match="max\\|err\\| vs reference"):
        fig16.run("cpu", quick=True)


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------
def test_quickstart_backends_are_jax_and_within_tolerance():
    rows = quickstart.backend_errors("cpu")
    names = [b for b, _, _ in rows]
    assert names == list(registered_backends())
    for backend, err, tol in rows:
        assert err <= tol, backend
    pytest.importorskip("jax")
    from repro.kernels import registered_backends as jax_backends
    assert names == list(jax_backends())


def test_quickstart_main(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "auto plan on H100 SXM (fp32/TF32, data sheet)" in out
    assert "wrapper parity      : bit-identical" in out
    assert "TPU" not in out


def test_sweet_spot_a100_surfaces_equal_jax(capsys):
    port = "\n".join(sweet_spot_explorer.lines())
    cut = port.index("\n=== H100")
    jax_mod = _jax_file("examples/sweet_spot_explorer.py")
    capsys.readouterr()
    jax_mod.main()
    jax = capsys.readouterr().out
    assert port[:cut] + "\n" == jax[:jax.index("\n=== TPU")] + "\n"
    assert "TPU" not in port


def test_sweet_spot_h100_surface():
    lines = sweet_spot_explorer.lines()
    at = lines.index("\n=== H100 SXM fp32/TF32 (data sheet), banded "
                     f"tensor-core scheme, BAND_N={BAND_N} (this port) ===")
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[at + 2:at + 7]}
    hw = pm.H100_SXM_DATASHEET
    for name, marks in rows.items():
        spec = StencilSpec.from_name(name)
        for t, mark in enumerate(marks, 1):
            c = pm.compare(pm.StencilWorkload(spec, t, 4), hw,
                           pm.sparsity_banded(spec.radius * t, BAND_N))
            assert mark == {1: "=", 2: "x", 3: "O",
                            4: "o" if c.profitable else "x"}[c.scenario.value]


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------
_IMPORTS_JAX = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in list((ROOT / "src" / "repro_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_no_module_of_the_port_imports_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORTS_JAX.search(text), path
