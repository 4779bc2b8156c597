#!/bin/bash
# Snapshot gate: run this before committing.  Exits nonzero unless
#   1. the fast suite is green (CPU),
#   2. the load-bearing slow subset is green (CPU: kernel<->jnp parity for
#      all three integrators in interpret mode, kernel-path gradients,
#      sharding identity),
#   3. chip_smoke.py passes on the GPU (skipped with --no-chip).
# Each stage's result is written to scripts/out/GATE.json (not committed).
# Usage:  bash scripts/gate.sh [--no-chip]
set -uo pipefail
cd "$(dirname "$0")/.."
mkdir -p scripts/out
GATE_JSON=scripts/out/GATE.json
T_START=$(date +%s)

declare -A STAGE_RC STAGE_SUMMARY STAGE_S

run_stage() {
  local name="$1"; shift
  echo "=== gate: $name ==="
  local t0=$(date +%s)
  local log
  log=$("$@" 2>&1 | tee /dev/stderr | tail -40)
  local rc=${PIPESTATUS[0]}
  STAGE_RC[$name]=$rc
  STAGE_S[$name]=$(( $(date +%s) - t0 ))
  # pytest summary line ("77 passed, 24 deselected in 559s") or last line.
  STAGE_SUMMARY[$name]=$(grep -Eo '[0-9]+ (passed|failed)[^=]*' <<<"$log" | tail -1)
  [ -z "${STAGE_SUMMARY[$name]}" ] && STAGE_SUMMARY[$name]=$(tail -1 <<<"$log")
  return $rc
}

FAIL=0
JAX_PLATFORMS=cpu run_stage "fast_suite" \
  python -m pytest tests/ -q -m "not slow" -x || FAIL=1

JAX_PLATFORMS=cpu run_stage "slow_subset" python -m pytest -q -x \
  "tests/test_pallas.py::test_pallas_euler_matches_jnp" \
  "tests/test_pallas.py::test_pallas_rk45_matches_jnp" \
  "tests/test_pallas.py::test_pallas_kerr_matches_jnp" \
  "tests/test_march_grad.py" \
  "tests/test_dist.py::test_sharded_trace_matches_single_device" \
  "tests/test_dist.py::test_sharded_pallas_interpret_matches_single_device" || FAIL=1

if [[ "${1:-}" == "--no-chip" ]]; then
  STAGE_RC[chip_smoke]=-1
  STAGE_SUMMARY[chip_smoke]="SKIPPED (--no-chip)"
  STAGE_S[chip_smoke]=0
  echo "=== gate: chip_smoke SKIPPED (--no-chip) ==="
else
  run_stage "chip_smoke" python chip_smoke.py || FAIL=1
fi

for name in fast_suite slow_subset chip_smoke; do
  export "GATE_RC_${name}=${STAGE_RC[$name]:-1}"
  export "GATE_SUMMARY_${name}=${STAGE_SUMMARY[$name]:-}"
  export "GATE_S_${name}=${STAGE_S[$name]:-0}"
done
GATE_FAIL=$FAIL GATE_TOTAL_S=$(( $(date +%s) - T_START )) \
python - "$GATE_JSON" <<'PY'
import datetime, json, os, sys
stages = {
    name: dict(
        rc=int(os.environ[f"GATE_RC_{name}"]),
        summary=os.environ[f"GATE_SUMMARY_{name}"].strip(),
        wall_s=int(os.environ[f"GATE_S_{name}"]),
    )
    for name in ("fast_suite", "slow_subset", "chip_smoke")
}
out = dict(
    green=not int(os.environ["GATE_FAIL"]),
    stages=stages,
    total_wall_s=int(os.environ["GATE_TOTAL_S"]),
    timestamp=datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds"),
)
json.dump(out, open(sys.argv[1], "w"), indent=1)
print("wrote", sys.argv[1], "green =", out["green"])
PY

if [ "$FAIL" -ne 0 ]; then
  echo "gate: FAILED (see $GATE_JSON)"
  exit 1
fi
echo "gate: ALL GREEN"
