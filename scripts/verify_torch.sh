#!/usr/bin/env bash
# The port's verification (the counterpart of scripts/verify.sh, which
# stays the JAX package's): the env lint of src/repro_torch, the port's
# tests, the static plan audit, and the benchmark harness in quick mode,
# then the same invariants verify.sh asserts, on the port's manifest and
# BENCH_torch_kernels.quick.json.  Run from anywhere:
#
#   scripts/verify_torch.sh                # the harness on the card
#   scripts/verify_torch.sh --device cpu   # the plain versions on the CPU
#
# The tests run on the CPU either way (the tests that need the card skip
# there); with pytest-xdist installed they run in VERIFY_WORKERS (default
# 6) processes.
set -euo pipefail
cd "$(dirname "$0")/.."

DEVICE=cuda
while [ $# -gt 0 ]; do
  case "$1" in
    --device) DEVICE="$2"; shift 2 ;;
    --device=*) DEVICE="${1#--device=}"; shift ;;
    *) echo "verify_torch.sh: unknown argument $1" >&2; exit 2 ;;
  esac
done
case "$DEVICE" in cuda|cpu) ;; *) echo "verify_torch.sh: --device cuda|cpu" >&2; exit 2 ;; esac

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
export BENCH_QUICK=1

# Every REPRO_* knob of the port is read through core/envutil.
python scripts/lint_env.py src/repro_torch

# The port's tests (they import the JAX package as their reference).
if python -c "import xdist" 2>/dev/null; then
  python -m pytest -q -p no:cacheprovider -n "${VERIFY_WORKERS:-6}" --dist loadfile \
    tests/test_torch_*.py
else
  python -m pytest -q -p no:cacheprovider tests/test_torch_*.py
fi

# The static plan audit: exits nonzero on any violation.
python -m repro_torch.audit

MANIFEST="BENCH_torch_run.json"
python -m repro_torch.benchmarks.run --quick --device "$DEVICE" --manifest "$MANIFEST"

python - "$MANIFEST" <<'EOF'
import json, sys
with open(sys.argv[1]) as f:
    manifest = json.load(f)
failed = manifest["failed"]
assert not failed, f"benchmark module(s) failed: {', '.join(failed)}"
assert "traffic" in manifest["succeeded"], \
    "traffic module missing from the benchmark manifest"
print(f"verify_torch: {len(manifest['succeeded'])} benchmark modules OK "
      f"on {manifest['device_name']}")

path = "BENCH_torch_kernels.quick.json"
with open(path) as f:
    data = json.load(f)
assert data["device"] == manifest["device"], (data["device"], manifest["device"])
timed_out = [c["case"] for group in ("cases", "cases_3d", "cases_wide",
                                     "cases_boundary")
             for c in data[group] if c.get("timed_out")]
if timed_out:
    print(f"verify_torch: WARNING {len(timed_out)} case(s) timed out: {timed_out}")
# 3D: the port's slab tile reads less than the whole-slab foil
cases = [c for c in data["cases_3d"] if not c.get("timed_out")]
assert cases, f"no (surviving) 3D traffic cases in {path}"
for c in cases:
    assert c["read_bytes_step_direct_tiled"] < \
        c["read_bytes_step_direct_wholestrip"], c["case"]
    assert c["read_amp_tiled"] < c["read_amp_wholestrip"], c["case"]
# the compacted contraction: bit for bit the dense reuse plan; star
# stencils fewer MMA FLOPs, box ones the same
sparse2d = [c for c in data["cases"] if not c.get("timed_out")]
sparse = sparse2d + cases
assert any(c["shape"] == "star" for c in sparse2d), "no 2D star case"
assert any(c["shape"] == "star" for c in cases), "no 3D star case"
for c in sparse:
    assert c["sparse_bitwise_equal"], \
        f"sparse output diverged from dense: {c['case']}"
    if c["shape"] == "star":
        assert c["mma_flops_step_sparse"] < c["mma_flops_step_dense"], c["case"]
        assert c["kept_row_fraction"] < 1.0, c["case"]
    else:
        assert c["mma_flops_step_sparse"] == c["mma_flops_step_dense"], c["case"]
        assert c["kept_row_fraction"] == 1.0, c["case"]
# every boundary mode within the oracle's tolerance; the overlap pair bit
# for bit with the interior launched before the receive (timing recorded,
# not gated)
bnd = [c for c in data["cases_boundary"] if not c.get("timed_out")]
assert bnd, f"no (surviving) boundary-mode cases in {path}"
for c in bnd:
    assert c["oracle_within_tol"], (c["case"], c["oracle_max_err"], c["oracle_tol"])
ov = data["halo_overlap"]
assert "us_step_overlap" in ov, f"the overlap pair did not run: {ov}"
assert ov["bitwise_equal"], "overlap stepper != serialized foil"
assert ov["interleave_counters"]["interior_before_recv_consumed"] > 0
# the wide grid: the port's column tile below the whole-width foil
wide = [c for c in data["cases_wide"] if not c.get("timed_out")]
assert wide, f"no (surviving) wide-grid cases in {path}"
for c in wide:
    assert c["w_tile"] > 0 and c["w_block"] > 0, c["case"]
    assert c["read_amp_coltiled"] < c["read_amp_wholestrip"], c["case"]
    assert c["read_bytes_step_direct_coltiled"] < \
        c["read_bytes_step_direct_wholestrip"], c["case"]
# a clean run degrades nothing
guard = data["guard_events"]
assert guard.get("events", []) == [], f"guard events on a clean run: {guard['events']}"
assert guard.get("dropped", 0) == 0, "guard event ring buffer overflowed"
stats = data["plan_stats"]
for k in ("build_failures", "exec_failures", "fallbacks"):
    assert stats.get(k, 0) == 0, f"clean run but plan_stats[{k!r}]={stats[k]}"
print(f"verify_torch: {len(cases)} 3D case(s), tile < whole-slab foil; "
      f"{len(wide)} wide case(s), column tile < whole-width foil; "
      f"{len(sparse)} sparse case(s) bit for bit the dense; {len(bnd)} "
      f"boundary case(s) within the oracle's tolerance; overlap pair bit "
      f"for bit; guard event log clean ({data['timing']})")
EOF
