"""The port's UAV agent, scheduler controller and their binaries against
the JAX package's (tests/test_uav_scheduler.py's scenarios).

Each scenario runs once through each package, on its own fake cluster and
agent, and returns what a user of that package sees: the scheduling
requests' status (placement, score, phase, message), the agent's HTTP
replies and pushed reports, the binaries' exit codes and output.  The
port's must equal the JAX package's, and each scenario also checks the
decision it is about.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import time
import types
import urllib.error
import urllib.request

import pytest

from k8s_llm_monitor_tpu.cmd import demo as jdemo
from k8s_llm_monitor_tpu.cmd import scheduler as jsched_cmd
from k8s_llm_monitor_tpu.cmd import test_k8s as jtest_k8s
from k8s_llm_monitor_tpu.monitor import agent as jagent
from k8s_llm_monitor_tpu.monitor import client as jclient
from k8s_llm_monitor_tpu.monitor import cluster as jcluster
from k8s_llm_monitor_tpu.monitor import models as jmodels
from k8s_llm_monitor_tpu.monitor import scheduler as jscheduler
from k8s_llm_monitor_tpu_torch.cmd import demo as tdemo
from k8s_llm_monitor_tpu_torch.cmd import scheduler as tsched_cmd
from k8s_llm_monitor_tpu_torch.cmd import test_k8s as ttest_k8s
from k8s_llm_monitor_tpu_torch.monitor import agent as tagent
from k8s_llm_monitor_tpu_torch.monitor import client as tclient
from k8s_llm_monitor_tpu_torch.monitor import cluster as tcluster
from k8s_llm_monitor_tpu_torch.monitor import models as tmodels
from k8s_llm_monitor_tpu_torch.monitor import scheduler as tscheduler

PKGS = {
    "jax": types.SimpleNamespace(
        agent=jagent, client=jclient, cluster=jcluster, models=jmodels,
        scheduler=jscheduler, demo=jdemo, sched_cmd=jsched_cmd,
        test_k8s=jtest_k8s),
    "torch": types.SimpleNamespace(
        agent=tagent, client=tclient, cluster=tcluster, models=tmodels,
        scheduler=tscheduler, demo=tdemo, sched_cmd=tsched_cmd,
        test_k8s=ttest_k8s),
}


def both(scenario, *args):
    """The scenario's outcome through each package: (jax, torch)."""
    return scenario(PKGS["jax"], *args), scenario(PKGS["torch"], *args)


# ---------------------------------------------------------------- scheduler


def _world(ns):
    fake = ns.cluster.FakeCluster()
    fake.add_node("node-a")
    fake.add_node("node-b")
    fake.add_node("node-tpu", tpu_chips=4)
    fake.define_crd("monitoring.io", "UAVMetric", "uavmetrics")
    fake.define_crd("scheduler.io", "SchedulingRequest", "schedulingrequests")
    return fake, ns.client.Client(fake, namespaces=["default"])


def _push(ns, client, node, battery, status="active", age_s=None,
          heartbeat=None):
    kw = {}
    if age_s is not None:
        kw["timestamp"] = ns.models.utcnow() - datetime.timedelta(
            seconds=age_s)
    if heartbeat is not None:
        kw["heartbeat_interval_seconds"] = heartbeat
    client.upsert_uav_metric("", ns.models.UAVReport(
        node_name=node, uav_id=f"uav-{node}", status=status,
        state={"gps": {"latitude": 1.0},
               "battery": {"remaining_percent": battery},
               "flight": {"mode": "AUTO"},
               "health": {"system_status": "OK"}}, **kw))


def _request(fake, name, workload="job-1", min_battery=None, preferred=None):
    spec = {"workload": {"name": workload, "namespace": "default"}}
    if min_battery is not None:
        spec["minBatteryPercent"] = min_battery
    if preferred:
        spec["preferredNodes"] = preferred
    fake.create_custom_resource(
        "scheduler.io", "v1", "schedulingrequests", "default",
        {"metadata": {"name": name}, "spec": spec})


def _status(fake, name) -> dict:
    st = fake.get_custom_resource("scheduler.io", "v1", "schedulingrequests",
                                  "default", name)["status"]
    # Wall-clock stamps differ between two runs; the decision does not.
    return {k: v for k, v in st.items() if k != "lastUpdated"}


# name -> (pushes (node, battery, status, age_s, heartbeat), request kwargs,
#          SchedulerConfig kwargs, the expected (phase, node))
SCHED = {
    "best_battery": ([("node-a", 90.0), ("node-b", 60.0)], {},
                     {"tpu_node_bonus": 0}, ("Assigned", "node-a")),
    "preferred_bonus": ([("node-a", 90.0), ("node-b", 85.0)],
                        {"preferred": ["node-b"]}, {"tpu_node_bonus": 0},
                        ("Assigned", "node-b")),
    "tpu_bonus": ([("node-a", 88.0), ("node-tpu", 85.0)], {},
                  {"tpu_node_bonus": 5.0}, ("Assigned", "node-tpu")),
    "filters": ([("node-a", 25.0), ("node-b", 80.0, "stale")],
                {"min_battery": 30}, {}, ("Failed", None)),
    "no_battery_filter": ([("node-a", 5.0)], {}, {"tpu_node_bonus": 0},
                          ("Assigned", "node-a")),
    "empty_status_and_case": ([("node-a", 70.0, ""),
                               ("node-b", 70.0, "Active")],
                              {"preferred": ["NODE-B"]},
                              {"tpu_node_bonus": 0}, ("Assigned", "node-b")),
    "invalid_workload": ([], {"workload": ""}, {}, ("Failed", None)),
    "stale_heartbeat": ([("node-a", 95.0, "active", 60, 10),
                         ("node-b", 40.0)], {}, {"tpu_node_bonus": 0},
                        ("Assigned", "node-b")),
    "stale_default_cap": ([("node-a", 95.0, "active", 600),
                           ("node-b", 50.0, "active", 30)], {},
                          {"tpu_node_bonus": 0}, ("Assigned", "node-b")),
}


def _schedule(ns, name):
    pushes, req_kw, cfg_kw, _ = SCHED[name]
    fake, client = _world(ns)
    for push in pushes:
        _push(ns, client, *push)
    _request(fake, "req", **req_kw)
    ctrl = ns.scheduler.SchedulerController(
        client, ns.scheduler.SchedulerConfig(**cfg_kw))
    first, second = ctrl.reconcile(), ctrl.reconcile()
    return first, second, _status(fake, "req")


@pytest.mark.parametrize("name", list(SCHED))
def test_scheduler_decisions_match_jax(name):
    want, got = both(_schedule, name)
    assert got == want
    first, second, status = got
    phase, node = SCHED[name][3]
    assert (first, second) == (1, 0)       # a settled request is skipped
    assert status["phase"] == phase, status
    if node is not None:
        assert status["assignedNode"] == node
        assert status["assignedUAV"] == f"uav-{node}"


# -------------------------------------------------------------------- agent


def _http(port, path, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, None


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


@contextlib.contextmanager
def _agent(ns, **kw):
    posted = []
    a = ns.agent.UAVAgent(
        node_name="node-1", node_ip="10.0.0.1", port=0,
        master_url="http://master:8081", report_interval=3600,
        poster=kw.pop("poster", lambda url, p: posted.append((url, p))),
        **kw)
    a.start()
    try:
        yield a, posted
    finally:
        a.stop()


def _surface(ns):
    with _agent(ns) as (a, _):
        code, health = _http(a.port, "/health")
        health.pop("timestamp")
        out = {"health": (code, health)}
        code, state = _http(a.port, "/api/v1/state")
        out["state"] = (code, sorted(state), state["node_name"])
        for sub in ("gps", "attitude", "battery", "flight"):
            code, part = _http(a.port, f"/api/v1/{sub}")
            out[sub] = (code, sorted(part), sorted(state[sub]))
        return out


def test_agent_http_surface_matches_jax():
    want, got = both(_surface)
    assert got == want
    assert got["health"][1]["status"] == "healthy"
    assert got["health"][1]["uav_id"] == "uav-node-1"
    assert got["state"][2] == "node-1"


COMMANDS = (("arm", None), ("takeoff", {"altitude": 80}),
            ("mode", {"mode": "LOITER"}), ("rtl", None), ("land", None),
            ("disarm", None), ("explode", None))


def _commands(ns):
    with _agent(ns) as (a, _):
        out = []
        for cmd, body in COMMANDS:
            code, reply = _http(a.port, f"/api/v1/command/{cmd}", body or {})
            flight = a.simulator.get_state()["flight"]
            out.append((cmd, code, reply and reply.get("status"),
                        flight["mode"], flight["armed"]))
        return out


def test_agent_commands_match_jax():
    want, got = both(_commands)
    assert got == want
    modes = {cmd: (code, mode) for cmd, code, _, mode, _ in got}
    assert modes["takeoff"] == (200, "AUTO")
    assert modes["mode"] == (200, "LOITER")
    assert modes["land"] == (200, "LAND")
    assert got[-2][4] is False               # disarmed
    assert modes["explode"][0] == 404


def _report(ns):
    with _agent(ns) as (a, posted):
        assert _wait(lambda: bool(posted))
        url, payload = posted[0]
        return url, {k: v for k, v in payload.items()
                     if k not in ("timestamp", "state")}, \
            payload["state"]["battery"]["remaining_percent"]


def test_agent_report_push_matches_jax():
    want, got = both(_report)
    assert got == want
    url, payload, battery = got
    assert url == "http://master:8081/api/v1/uav/report"
    assert payload["source"] == "agent"
    assert payload["heartbeat_interval_seconds"] == 3600
    assert battery == 100.0


def _end_to_end(ns):
    fake, client = _world(ns)

    def post(url, payload):
        client.upsert_uav_metric("", ns.models.UAVReport(**{
            k: v for k, v in payload.items()
            if k in ("node_name", "uav_id", "source", "status", "state")}))

    a = ns.agent.UAVAgent(node_name="node-a", port=0,
                          master_url="http://master", report_interval=3600,
                          poster=post)
    a.start()
    try:
        assert _wait(lambda: a.reports_sent > 0)
        _request(fake, "req-e2e")
        ns.scheduler.SchedulerController(client).reconcile()
        return _status(fake, "req-e2e")
    finally:
        a.stop()


def test_agent_to_scheduler_end_to_end_matches_jax():
    want, got = both(_end_to_end)
    assert got == want
    assert got["phase"] == "Assigned" and got["assignedNode"] == "node-a"


# ----------------------------------------------------------------- binaries


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("demo", ["debug-test", "network-demo", "crd-demo"])
def test_demo_output_matches_jax(demo):
    want, got = both(lambda ns: _run(ns.demo.main, [demo, "--seconds",
                                                    "0.2"]))
    assert got == want
    assert got[0] == 0 and got[1]


def test_scheduler_binary_once_matches_jax():
    want, got = both(lambda ns: ns.sched_cmd.main(["--cluster", "fake",
                                                   "--once"]))
    assert got == want == 0


def test_test_k8s_binary_matches_jax():
    def run(ns):
        rc, text = _run(ns.test_k8s.main, ["--cluster", "fake",
                                           "--watch-seconds", "0.2"])
        return rc, [line.split(":")[0] for line in text.splitlines()
                    if line.startswith("===")]

    want, got = both(run)
    assert got == want
    assert got[0] == 0 and got[1][-1] == "=== all checks passed ==="
