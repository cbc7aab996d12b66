# Build/run targets (parity: /root/reference/Makefile, minus its broken
# cmd/agent reference — the agent entrypoint here is cmd.uav_agent).

PY ?= python
TEST_ENV = env PYTHONPATH= JAX_PLATFORMS=cpu
SHELL := /bin/bash    # tier1 uses pipefail/PIPESTATUS

.PHONY: run run-agent run-scheduler demo test test-fast tier1 tier1-mesh \
        chaos chaos-lifecycle chaos-fleet chaos-overload chaos-kvtier \
        chaos-trace chaos-signals chaos-elastic chaos-tenant \
        chaos-remediate \
        diagnose-e2e bench bench-decode \
        bench-fleet bench-mesh bench-signals bench-elastic bench-prefill \
        bench-tenant bench-remediate \
        dryrun smoke \
        preflight \
        deploy-agent docker \
        docker-agent docker-scheduler lint lint-contracts lint-trace \
        lint-torch clean

run:
	$(PY) -m k8s_llm_monitor_tpu.cmd.server --cluster fake --port 8081

run-agent:
	$(PY) -m k8s_llm_monitor_tpu.cmd.uav_agent --port 9090

run-scheduler:
	$(PY) -m k8s_llm_monitor_tpu.cmd.scheduler --cluster fake

demo:
	$(PY) -m k8s_llm_monitor_tpu.cmd.demo debug-test

test:
	$(TEST_ENV) $(PY) -m pytest tests/ -q

test-fast:          # monitor plane only (no jax compiles)
	$(TEST_ENV) $(PY) -m pytest tests/ -q \
	  --ignore=tests/test_model_parity.py \
	  --ignore=tests/test_engine.py \
	  --ignore=tests/test_sharding.py \
	  --ignore=tests/test_real_artifact_e2e.py

tier1:              # the driver's verify gate, verbatim (ROADMAP.md)
	set -o pipefail; rm -f /tmp/_t1.log; \
	timeout -k 10 1350 env JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q \
	  -m 'not slow' --continue-on-collection-errors -p no:cacheprovider \
	  -p no:xdist -p no:randomly 2>&1 | tee /tmp/_t1.log; \
	rc=$${PIPESTATUS[0]}; \
	echo DOTS_PASSED=$$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$$' /tmp/_t1.log \
	  | tr -cd . | wc -c); \
	exit $$rc

# Mesh acceptance: TP-8 parity + SpecLayout + traceguard mesh path on the
# simulated 8-device CPU mesh, with lock discipline checked.  (conftest.py
# forces the 8-device XLA flag; set here too so the leg is self-contained.)
tier1-mesh:
	$(TEST_ENV) XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_sharding.py tests/test_spec_decode.py \
	  tests/test_overlap.py tests/test_flash_prefill.py -q \
	  -p no:cacheprovider

chaos:              # fault-injection resilience suite (docs/resilience.md)
	$(TEST_ENV) $(PY) -m pytest tests/ -q -m chaos -p no:cacheprovider

# Crash-safe lifecycle acceptance: WAL + supervisor + handover, with lock
# discipline checked and journal fsync off (CI speed).
chaos-lifecycle:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 K8SLLM_JOURNAL_FSYNC=never \
	  $(PY) -m pytest tests/test_lifecycle.py -q -p no:cacheprovider

# Fleet tier acceptance: router policies, hedging, 32-stream mid-kill
# failover (docs/fleet.md), with lock discipline checked.
chaos-fleet:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_fleet.py -q -p no:cacheprovider

# SLO-class overload acceptance: class-ordered shedding, preemptive lane
# eviction (byte-exact, with seeded eviction faults), the brownout ladder,
# and the 3x-capacity mixed-class burst (docs/resilience.md) — with lock
# discipline checked.
chaos-overload:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_overload.py -q -p no:cacheprovider

# KV-tier acceptance (docs/serving.md "KV tiers & prefix migration"):
# quantized-KV greedy parity, host-RAM spill/restore byte-exactness,
# supervisor-rebuild rehydration (+ replay fallback with the spill buffer
# gone), and cross-replica migration with a mid-migration replica kill —
# with lock discipline checked.
chaos-kvtier:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_kv_tier.py -q -p no:cacheprovider

# Tracing acceptance (docs/observability.md): span-ring bounds, seeded
# sampling determinism, the live router→2-replica merged trace with a
# hedge + forced mid-stream failover, flight-recorder dump on a seeded
# watchdog fault, and exposition lint — with lock discipline checked.
chaos-trace:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_tracing.py -q -p no:cacheprovider

# Telemetry-plane acceptance (docs/observability.md "Signals & time
# series"): ring-store math under a fake clock, fleet staleness NaN
# discipline, derived scale hints, the anomaly→diagnosis feed, and the
# live 2-replica flood→scale-up→decay loop — with lock discipline checked.
chaos-signals:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_signals.py -q -p no:cacheprovider

# Disaggregated-fleet + elasticity acceptance (docs/fleet.md
# "Disaggregated roles & autoscaling"): the prefill→decode handoff ladder
# (every install failure degrades to local decode, byte-exact), drain
# lifecycle with the budget-bounded prefix sweep, AutoscaleController
# hysteresis gates under a fake clock, and the 2-prefill/2-decode
# chaos burst with scale-up + drain-down + rebalance mid-burst — with
# lock discipline checked.
chaos-elastic:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_elasticity.py -q -p no:cacheprovider

# Multi-tenant hardening acceptance (docs/resilience.md "Tenancy &
# quotas"): identity normalization at the trust boundary, the
# TenantGovernor reservation protocol (charged == delivered across
# hedges, failovers, and a mid-stream replica kill), tenant-namespaced
# KV isolation (cross-tenant lookups structurally miss, tenant_mismatch
# installs refused), exporter top-K cardinality, and the flooding-tenant
# burst with seeded lane_eviction faults — with lock discipline checked.
chaos-tenant:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_tenancy.py -q -p no:cacheprovider

# Closed-loop remediation acceptance (docs/remediation.md): plan-grammar
# property fuzz (every constrained sample parses and names a live
# target), executor gate units on a fake clock (dry-run-first ordering,
# breaker trip, approval required, idempotent replay), and the
# four-scenario chaos e2e — crash loop, OOM, stale scheduler, node
# pressure: inject → detect → plan → execute → verified recovery — with
# lock discipline checked.
chaos-remediate:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_remediation.py -q -p no:cacheprovider

# Diagnosis acceptance (docs/diagnosis.md): grammar compiler units, the
# constrained-sampling fuzz (every sample parses), and the synthetic
# crash-loop burst → verdict e2e — with lock discipline checked.
diagnose-e2e:
	$(TEST_ENV) K8SLLM_LOCKCHECK=1 \
	  $(PY) -m pytest tests/test_grammar.py tests/test_diagnosis.py -q \
	  -p no:cacheprovider

bench:
	$(PY) bench.py

bench-decode:       # fused-vs-fallback decode microbench + phase attribution
	env BENCH_CONCURRENCY=8 BENCH_MAX_TOKENS=16 $(PY) bench.py

bench-fleet:        # CPU fleet smoke: 1-vs-2 replicas, hedged tail latency
	$(TEST_ENV) BENCH_FLEET_ONLY=1 BENCH_MODEL=tiny \
	  $(PY) bench.py | tee fleet-bench.json

# TP-mesh serving dryrun: p50/p99 TTFT + tok/s through one tensor-parallel
# engine on a forced 8-host-device CPU mesh (JSON flagged mesh_dryrun).
# The measured leg runs inside plain `make bench` on real multi-chip
# hardware and supersedes the perchip_equiv_* arithmetic.
bench-mesh:
	$(TEST_ENV) XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  BENCH_MESH_ONLY=1 BENCH_MODEL=tiny BENCH_QUANT=none \
	  BENCH_MESH_CONCURRENCY=12 BENCH_MESH_PROMPT_LEN=48 \
	  BENCH_MESH_MAX_TOKENS=12 BENCH_MESH_SLOTS=8 \
	  $(PY) bench.py | tee mesh-bench.json

# Long-prefill smoke: flash-vs-dense TTFT ladder, the chunked-vs-single-
# bucket crossover, the int8-pool variant, and the dense-skip branch
# (analytic transient bytes over budget) on a tiny CPU engine.  The
# measured 2k/8k/32k leg runs on real TPU hardware with the defaults.
bench-prefill:
	$(TEST_ENV) BENCH_PREFILL_ONLY=1 BENCH_MODEL=tiny BENCH_QUANT=none \
	  $(PY) bench.py | tee prefill-bench.json

# Telemetry-plane overhead smoke: scraper-on vs scraper-off tok/s on a
# tiny CPU engine; asserts the < 1% budget and persists the derived
# signal snapshot with the artifact.
bench-signals:
	$(TEST_ENV) BENCH_SIGNALS_ONLY=1 BENCH_MODEL=tiny BENCH_QUANT=none \
	  $(PY) bench.py | tee signals-bench.json

# Elasticity reaction smoke: reaction time from hint to first scale-up,
# TTFT p99 churn-vs-steady ratio, and the handoff-vs-local-prefill TTFT
# ratio on a tiny CPU fleet.
bench-elastic:
	$(TEST_ENV) BENCH_ELASTIC_ONLY=1 BENCH_MODEL=tiny BENCH_QUANT=none \
	  $(PY) bench.py | tee elastic-bench.json

# Multi-tenant fairness smoke: flooding tenant rate-limited with
# tenant-tagged 429s while quiet Zipf tenants stay byte-exact within the
# 2x-solo interactive TTFT budget, charged tokens == delivered tokens.
bench-tenant:
	$(TEST_ENV) BENCH_TENANT_ONLY=1 BENCH_MODEL=tiny BENCH_QUANT=none \
	  $(PY) bench.py | tee tenant-bench.json

# Remediation smoke: inject→verified-recovery latency for each chaos
# scenario on the template backend, plus constrained-vs-free plan decode
# tok/s on a tiny CPU engine (asserts the < 10% overhead budget).
bench-remediate:
	$(TEST_ENV) BENCH_REMEDIATE_ONLY=1 BENCH_MODEL=tiny BENCH_QUANT=none \
	  $(PY) bench.py | tee remediation-bench.json

smoke:              # boot server + 20-check live API suite
	$(TEST_ENV) bash scripts/smoke.sh

preflight:          # will the model/quant/mesh fit? (no weights built)
	$(PY) -m k8s_llm_monitor_tpu.cmd.preflight --model llama3-8b \
	  --quantize w8a8 --mesh 1,1,8 --kv-blocks 2200 --per-chip-hbm-gib 16

deploy-agent:       # build agent image, k3d import, roll out DaemonSet
	bash scripts/build-and-deploy-uav-agent.sh

dryrun:
	env PYTHONPATH= $(PY) __graft_entry__.py 8

docker:
	docker build -t k8s-llm-monitor-tpu-server:dev -f Dockerfile .

docker-agent:
	docker build -t k8s-llm-monitor-tpu-agent:dev -f Dockerfile.agent .

docker-scheduler:
	docker build -t k8s-llm-monitor-tpu-scheduler:dev -f Dockerfile.scheduler .

LINT_PATHS = k8s_llm_monitor_tpu tests bench.py __graft_entry__.py

lint:               # compileall + graftcheck always; ruff/mypy when installed
	$(PY) -m compileall -q k8s_llm_monitor_tpu
	@if $(PY) -c "import ruff" >/dev/null 2>&1; then \
	  $(PY) -m ruff check $(LINT_PATHS); \
	else echo "lint: ruff not installed, skipping (config in pyproject.toml)"; fi
	@if $(PY) -c "import mypy" >/dev/null 2>&1; then \
	  $(PY) -m mypy --config-file pyproject.toml; \
	else echo "lint: mypy not installed, skipping (config in pyproject.toml)"; fi
	$(TEST_ENV) $(PY) -m k8s_llm_monitor_tpu.devtools.graftcheck \
	  --dataflow --contracts $(LINT_PATHS)

lint-contracts:     # fast path: contract-drift checks only (no package import)
	$(TEST_ENV) $(PY) -m k8s_llm_monitor_tpu.devtools.graftcheck \
	  --contracts k8s_llm_monitor_tpu/devtools/contracts.py

lint-trace:         # lint + trace-time guards (jit-compiles a tiny engine)
	$(TEST_ENV) $(PY) -m k8s_llm_monitor_tpu.devtools.graftcheck --trace $(LINT_PATHS)

lint-torch:         # the PyTorch port's graftcheck: the static passes, on the CPU
	$(PY) -m k8s_llm_monitor_tpu_torch.devtools.graftcheck --dataflow --contracts

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
