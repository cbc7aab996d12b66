"""graftcheck CLI: the single entry point for the port's analysis passes.

    python -m k8s_llm_monitor_tpu_torch.devtools.graftcheck [paths...]
        AST lint over the given paths (default: the port's package).
        Exit 0 = clean, 1 = findings.

    python -m k8s_llm_monitor_tpu_torch.devtools.graftcheck --dataflow
        Additionally run the whole-program dataflow pass (call graph +
        taint): blocking-in-hot-path, capture-hazard, lock-order-static.
        Analyzes the package as one program, so it ignores positional
        ``paths``.

    python -m k8s_llm_monitor_tpu_torch.devtools.graftcheck --contracts
        Additionally run the contract-drift checkers (routes, metrics,
        env keys, the table of what the port does not serve yet) against
        README.md, docs/ and the Makefile.

    python -m k8s_llm_monitor_tpu_torch.devtools.graftcheck --trace
        Additionally run the engine guards (no new program or capture on
        a same-bucket repeat, live buffers after reset, preemption,
        restore and a grammar swap; on the card, replays under
        ``torch.cuda.set_sync_debug_mode("error")``).  ``--device``
        defaults to ``cuda`` and raises without a card; ``--device cpu``
        runs the kernels' plain versions.  Slower (it builds tiny
        engines), so ``make lint-torch`` runs the static passes; the CPU
        trace pass is enforced by tests/test_torch_traceguard.py.

    --json emits one machine-readable document for CI annotation.
    --list-rules documents every rule and its name (the token used in
    `# graftcheck: disable=...` suppressions).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _package_root() -> Path:
    return Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="graftcheck",
        description="PyTorch-aware static analysis, contract-drift checks "
                    "+ engine guards for the port")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files/dirs to lint (default: the package)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output")
    parser.add_argument("--dataflow", action="store_true",
                        help="also run the interprocedural dataflow rules "
                             "(call graph over the whole package)")
    parser.add_argument("--contracts", action="store_true",
                        help="also run the contract-drift checkers "
                             "(routes/metrics/env vs README, docs/, "
                             "Makefile)")
    parser.add_argument("--trace", action="store_true",
                        help="also run the engine guards (builds tiny "
                             "engines; slower)")
    parser.add_argument("--trace-paths", default="",
                        help="comma-separated engine paths for --trace "
                             "(default: traceguard.DEFAULT_PATHS)")
    parser.add_argument("--device", default="cuda",
                        help="device of the --trace engines (default "
                             "cuda; cpu runs the kernels' plain versions)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print every rule and exit")
    args = parser.parse_args(argv)

    from k8s_llm_monitor_tpu_torch.devtools import astlint

    if args.list_rules:
        from k8s_llm_monitor_tpu_torch.devtools import contracts, dataflow

        for rule in astlint.default_rules():
            print(f"{rule.name}: {rule.description}")
        print("blocking-in-hot-path: blocking call reachable from a "
              "serving hot entry (--dataflow)")
        print("capture-hazard: host read / device sync in a CUDA graph's "
              "capture, or a captured input rebound (--dataflow)")
        print("lock-order-static: static lock acquisition-order cycle "
              "(--dataflow)")
        print("route-contract: routes registered vs documented, both "
              "directions (--contracts)")
        print("metrics-contract: exporter families vs docs inventory "
              "(--contracts)")
        print("env-contract: env reads vs ENV_KEYS registry vs docs, and "
              "the refused config keys vs DEFERRED (--contracts)")
        assert set(dataflow.DATAFLOW_RULE_NAMES) <= {
            "blocking-in-hot-path", "capture-hazard", "lock-order-static"}
        assert set(contracts.CONTRACT_RULE_NAMES) <= {
            "route-contract", "metrics-contract", "env-contract"}
        return 0

    paths = args.paths or [_package_root()]
    findings = astlint.lint_paths(paths)

    dataflow_findings = None
    if args.dataflow:
        from k8s_llm_monitor_tpu_torch.devtools import dataflow

        dataflow_findings = dataflow.analyze_paths([_package_root()])

    contract_findings = None
    if args.contracts:
        from k8s_llm_monitor_tpu_torch.devtools import contracts

        contract_findings = contracts.run_contracts(
            _package_root().parent)

    trace_report = None
    if args.trace:
        from k8s_llm_monitor_tpu_torch.devtools import traceguard

        trace_paths = tuple(p.strip() for p in args.trace_paths.split(",")
                            if p.strip()) or traceguard.DEFAULT_PATHS
        trace_report = traceguard.run_traceguard(trace_paths,
                                                 device=args.device)

    ok = (not findings
          and not dataflow_findings
          and not contract_findings
          and (trace_report is None or trace_report["ok"]))
    if args.as_json:
        doc = {
            "astlint": {
                "findings": [f.as_dict() for f in findings],
                "count": len(findings),
            },
            "dataflow": None if dataflow_findings is None else {
                "findings": [f.as_dict() for f in dataflow_findings],
                "count": len(dataflow_findings),
            },
            "contracts": None if contract_findings is None else {
                "findings": [f.as_dict() for f in contract_findings],
                "count": len(contract_findings),
            },
            "traceguard": trace_report,
            "ok": ok,
        }
        print(json.dumps(doc, indent=2))
    else:
        print(astlint.render(findings))
        if dataflow_findings is not None:
            from k8s_llm_monitor_tpu_torch.devtools import dataflow

            print(dataflow.render(dataflow_findings))
        if contract_findings is not None:
            from k8s_llm_monitor_tpu_torch.devtools import contracts

            print(contracts.render(contract_findings))
        if trace_report is not None:
            from k8s_llm_monitor_tpu_torch.devtools import traceguard

            print(traceguard.render(trace_report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
