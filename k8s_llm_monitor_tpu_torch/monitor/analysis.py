"""The Analysis Engine over the port's engine: LLM-backed cluster diagnosis.

The port's ``monitor/analysis.py``, as in the JAX package:

- the ``LLMBackend`` seam and its implementations: ``LocalEngineBackend``
  (in-process inference through the port's ``EngineService`` /
  ``EngineSupervisor`` and ``InferenceEngine``; verdicts are decoded under
  the verdict grammar's token FSM on the device, so they always parse),
  ``OpenAICompatBackend`` (a remote OpenAI-compatible endpoint) and
  ``TemplateBackend`` (a deterministic evidence summarizer: dev mode and
  tests without a model);
- ``build_backend``: the backend ``llm.provider`` names;
- ``EvidenceCollector``: bounded cluster evidence (snapshot + events +
  logs, capped by ``analysis.max_context_events``) as prompt sections;
- ``AnalysisEngine``: the three typed analyses (pod communication, anomaly
  detection, root cause), free-form ``query`` / ``query_stream`` /
  ``query_session`` and the constrained ``diagnose``.

``OpenAICompatBackend``, ``EvidenceCollector`` and ``AnalysisEngine`` are
the JAX package's code (``tests/test_torch_copies.py`` holds them to it).
``LocalEngineBackend.from_config`` builds the model on the GPU unless the
caller passes ``device="cpu"``; ``build_backend`` does not fall back to the
template backend when that fails.
"""

from __future__ import annotations

import http.client
import json
import logging
import re
import time
import urllib.error
import urllib.request
import uuid
from typing import Any

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
    GrammarError,
    parse_verdict,
    render_verdict,
    verdict_fsm,
)
from k8s_llm_monitor_tpu_torch.diagnosis.session import SessionManager
from k8s_llm_monitor_tpu_torch.models import llama
from k8s_llm_monitor_tpu_torch.models.config import PRESETS
from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import ClusterError
from k8s_llm_monitor_tpu_torch.monitor.config import (
    AnalysisConfig,
    LifecycleConfig,
    LLMConfig,
)
from k8s_llm_monitor_tpu_torch.monitor.manager import Manager
from k8s_llm_monitor_tpu_torch.monitor.models import (
    ANALYSIS_TYPES,
    AnalysisRequest,
    AnalysisResponse,
    to_jsonable,
    utcnow,
)
from k8s_llm_monitor_tpu_torch.monitor.network import NetworkAnalyzer
from k8s_llm_monitor_tpu_torch.ops import _build
from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError
from k8s_llm_monitor_tpu_torch.resilience.journal import RequestJournal
from k8s_llm_monitor_tpu_torch.resilience.retry import Backoff
from k8s_llm_monitor_tpu_torch.resilience.tenancy import TenantGovernor
from k8s_llm_monitor_tpu_torch.serving.engine import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from k8s_llm_monitor_tpu_torch.serving.service import EngineService
from k8s_llm_monitor_tpu_torch.serving.supervisor import EngineSupervisor
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

__all__ = ["AnalysisEngine", "EvidenceCollector", "LLMBackend",
           "LocalEngineBackend", "OpenAICompatBackend", "OverloadedError",
           "TemplateBackend", "build_backend"]

logger = logging.getLogger("monitor.analysis")


class LLMBackend:
    name = "base"

    def generate(
        self, prompt: str, max_tokens: int = 512, temperature: float = 0.1,
        slo_class: str = "standard", tenant: str = "",
    ) -> str:
        # ``slo_class`` and ``tenant`` are scheduling/accounting metadata
        # for backends with an admission layer (LocalEngineBackend); the
        # others accept and ignore them so callers can tag unconditionally.
        # ``tenant=""`` means the default tenant.
        raise NotImplementedError

    def generate_stream(
        self, prompt: str, max_tokens: int = 512, temperature: float = 0.1,
        slo_class: str = "standard", tenant: str = "",
    ):
        """Yield text chunks.  Backends without true streaming yield the
        whole completion once."""
        yield self.generate(prompt, max_tokens=max_tokens,
                            temperature=temperature, slo_class=slo_class,
                            tenant=tenant)

    def generate_constrained(self, prompt: str,
                             temperature: float = 0.0,
                             slo_class: str = "standard",
                             tenant: str = "") -> str:
        """Return Verdict JSON valid under ``diagnosis.grammar``'s schema.

        Default path for backends without token-level masking: generate
        free text and fold it into a canonical verdict via
        ``render_verdict``, so the output always parses.
        ``LocalEngineBackend`` overrides this with FSM-constrained decoding
        on the device.
        """
        text = self.generate(prompt, max_tokens=512,
                             temperature=temperature,
                             slo_class=slo_class, tenant=tenant).strip()
        try:
            parse_verdict(text)
            return text
        except GrammarError:
            pass
        low = text.lower()
        if any(w in low for w in ("crash", "oom", "fail", "critical",
                                  "unreachable", "down")):
            severity = "critical"
        elif any(w in low for w in ("warn", "pressure", "restart",
                                    "degrad", "evict")):
            severity = "warning"
        else:
            severity = "info"
        return render_verdict(
            severity, "cluster", text,
            "see root_cause; re-run the diagnosis after remediation", 0.3)

    #: True only for backends that can decode under an arbitrary token FSM
    #: (``LocalEngineBackend`` with the byte tokenizer).
    supports_grammar = False

    def generate_with_grammar(self, prompt: str, fsm,
                              temperature: float = 0.0,
                              slo_class: str = "standard",
                              tenant: str = "") -> str:
        """Decode under a caller-supplied ``TokenFSM``.  Backends without
        token-level masking return "" so callers fall back to their
        deterministic renderers."""
        return ""


def _evidence_issues(prompt: str) -> list[str]:
    return [line.strip("- ").strip() for line in prompt.splitlines()
            if line.lstrip().startswith("- ") and "##" not in line]


class TemplateBackend(LLMBackend):
    """Deterministic diagnosis text from the prompt's evidence sections
    (dev mode, fast tests); the same shape as the LLM path's output."""

    name = "template"

    def generate(
        self, prompt: str, max_tokens: int = 512, temperature: float = 0.1,
        slo_class: str = "standard", tenant: str = "",
    ) -> str:
        issues = _evidence_issues(prompt)
        if issues:
            listed = "; ".join(issues[:5])
            return (
                f"Diagnosis: {len(issues)} finding(s) in the collected evidence: "
                f"{listed}. Recommendation: address the findings above in order; "
                "re-run the analysis after each fix to confirm resolution."
            )
        return (
            "Diagnosis: no anomalies detected in the collected evidence. "
            "The cluster appears healthy; no action required."
        )

    def generate_constrained(self, prompt: str,
                             temperature: float = 0.0,
                             slo_class: str = "standard",
                             tenant: str = "") -> str:
        """A grammar-valid verdict from the evidence sections, rendered
        through the canonical serializer."""
        issues = _evidence_issues(prompt)
        if not issues:
            return render_verdict(
                "info", "cluster",
                "no anomalies detected in the collected evidence",
                "no action required", 0.9)
        low = " ".join(issues).lower()
        if any(w in low for w in ("crashloop", "crash", "oom", "failed",
                                  "notready", "unreachable")):
            severity = "critical"
        else:
            severity = "warning"
        pod = re.search(r'"pod": "([^"]+)"', prompt)
        component = pod.group(1) if pod else "cluster"
        return render_verdict(
            severity, component,
            f"{len(issues)} finding(s): {'; '.join(issues[:3])}",
            "address the findings in order; re-run the analysis after "
            "each fix", 0.6)


class LocalEngineBackend(LLMBackend):
    """In-process inference through the port's continuous-batching engine.

    Thread-safe and concurrent: an ``EngineService`` step thread owns the
    engine (and the card), and each generate() call submits a request and
    waits on its handle, so concurrent callers share prefill batches and
    decode steps.  A shed surfaces as ``OverloadedError`` from the service.
    """

    name = "gpu-local"

    # Generations that outlive this are failed (queue + decode worst case).
    GENERATION_TIMEOUT_S = 600.0

    def __init__(self, engine=None, tokenizer=None, *,
                 dev_weights: bool = False, engine_factory=None,
                 lifecycle: LifecycleConfig | None = None,
                 governor=None) -> None:
        """Two construction modes:

        * ``engine=``: the service wraps the given engine directly, and a
          dead step loop is terminal.
        * ``engine_factory=`` (``from_config``): an ``EngineSupervisor``
          owns the service, journals admits when ``lifecycle.journal_dir``
          is set, and rebuilds and replays on a dead or wedged step loop.
          The factory installs the verdict grammar on every engine it
          builds.
        """
        self.tokenizer = tokenizer
        self.supervisor = None
        self._service = None
        # resilience.tenancy.TenantGovernor (or None): per-tenant quotas,
        # owned here (above the supervisor) so reservations survive engine
        # rebuilds; the server reads it for /api/v1/stats.
        self.governor = governor
        if engine_factory is not None:
            lc = lifecycle or LifecycleConfig()
            journal = None
            if lc.journal_dir:
                journal = RequestJournal(
                    lc.journal_dir,
                    segment_max_bytes=lc.journal_segment_mb << 20,
                    fsync=lc.journal_fsync)
            self.supervisor = EngineSupervisor(
                engine_factory,
                journal=journal,
                max_restarts=lc.max_restarts,
                heartbeat_timeout_s=lc.heartbeat_timeout_s,
                backoff=Backoff(base_s=lc.restart_backoff_s,
                                cap_s=max(lc.restart_backoff_s * 8, 5.0),
                                jitter=0.0),
                governor=governor)
        else:
            if engine is None:
                raise ValueError("LocalEngineBackend needs engine= or "
                                 "engine_factory=")
            # Before the step thread starts: from then on only it touches
            # the engine.
            if getattr(engine, "_grammar", None) is None:
                self._install_verdict_grammar(engine, tokenizer)
            self._service = EngineService(engine, governor=governor)
        # Decode-rate EMAs (ms/token) behind constrained_decode_overhead_ms.
        self._ema_ms_constrained: float | None = None
        self._ema_ms_free: float | None = None
        # Serializes generate_with_grammar()'s set/decode/restore window.
        self._grammar_swap_lock = make_lock("analysis.grammar_swap")
        if dev_weights:
            # Random weights and the byte tokenizer give byte soup: say so
            # in every API response's `model` field.
            self.name = f"{type(self).name}-DEV-RANDOM-WEIGHTS"
            logger.warning(
                "GPU backend running with RANDOM-INIT weights (no "
                "llm.tpu.checkpoint configured): answers are not "
                "meaningful")

    @property
    def service(self) -> EngineService:
        """The live EngineService: the supervisor's current one when
        supervised (it changes across rebuilds), else the pinned one."""
        if self.supervisor is not None:
            return self.supervisor.service
        return self._service

    @property
    def engine(self):
        return self.service.engine

    def _submit(self, prompt_ids, sampling, slo_class: str = "standard",
                tenant: str = ""):
        if self.supervisor is not None:
            return self.supervisor.submit(prompt_ids, sampling,
                                          slo_class=slo_class,
                                          tenant=tenant)
        return self.service.submit(prompt_ids, sampling,
                                   slo_class=slo_class, tenant=tenant)

    def _call(self, fn):
        """Run ``fn(engine)`` on the step thread (the supervisor refuses
        while it rebuilds)."""
        if self.supervisor is not None:
            return self.supervisor.call(fn)
        return self.service.call(fn)

    def brownout_level(self) -> int:
        """Current brownout rung (0=normal, 1=degraded, 2=draining) from
        the live service's controller; 0 when no service is up."""
        svc = self.service
        if svc is None or getattr(svc, "brownout", None) is None:
            return 0
        return svc.brownout.level()

    @staticmethod
    def _install_verdict_grammar(engine, tokenizer) -> bool:
        """Register the Verdict token FSM on a fresh engine.

        Byte tokenizer only: the grammar's char -> token lift (token =
        byte + 3) is exact for ``ByteTokenizer``; other tokenizers would need
        a subword-aware compile, so constrained submits are refused for them
        (``generate_constrained`` takes the render path instead).
        """
        if not isinstance(tokenizer, ByteTokenizer):
            return False
        if engine.cfg.vocab_size < ByteTokenizer.vocab_size:
            return False
        try:
            engine.set_grammar(verdict_fsm(eos_id=tokenizer.eos_id))
        except ValueError as exc:
            logger.warning("verdict grammar not installed: %s", exc)
            return False
        return True

    def _note_decode_ms(self, constrained: bool, n_tokens: int,
                        latency_s: float, ttft_s: float) -> None:
        if n_tokens <= 1:
            return
        ms = max(0.0, latency_s - ttft_s) * 1000.0 / (n_tokens - 1)
        attr = "_ema_ms_constrained" if constrained else "_ema_ms_free"
        prev = getattr(self, attr)
        setattr(self, attr, ms if prev is None else 0.8 * prev + 0.2 * ms)

    @property
    def constrained_decode_overhead_ms(self) -> float:
        """Per-token decode cost of FSM masking: EMA(constrained) -
        EMA(free), clamped at 0; 0.0 until both classes have samples."""
        if self._ema_ms_constrained is None or self._ema_ms_free is None:
            return 0.0
        return max(0.0, self._ema_ms_constrained - self._ema_ms_free)

    @classmethod
    def from_config(cls, tpu_cfg, lifecycle=None, tenancy=None, *,
                    device=None) -> "LocalEngineBackend":
        """Build from ``LLMConfig.tpu``: random-init dev weights for the
        named preset, drawn on ``device`` (``cuda`` unless the caller asks
        for the CPU) from seed 0, behind a supervised engine factory.
        ``tenancy`` (TenancyConfig) arms the per-tenant admission governor.

        The knobs the port does not serve yet raise ``NotImplementedError``
        naming their ROADMAP item: ``quantize`` int8/w8a8 and
        ``checkpoint`` (A6), ``spec_k > 0`` (A4), ``mesh_shape`` (A7) and
        a tenant KV share below 1 (A3, the prefix cache it caps).  On the
        GPU the CUDA kernels are built here, before the supervisor's step
        loop starts, so no compile runs inside a heartbeat window.
        """
        qmode = getattr(tpu_cfg, "quantize", "")
        if qmode in ("int8", "w8a8"):
            raise NotImplementedError(
                f"llm.tpu.quantize={qmode!r}: int8 / W8A8 weights are not "
                "ported (ROADMAP A6); set llm.tpu.quantize to '' "
                "(LLM_TPU_QUANTIZE=) for bf16 weights")
        if tpu_cfg.checkpoint:
            raise NotImplementedError(
                "llm.tpu.checkpoint: checkpoint loading is not ported "
                "(ROADMAP A6); leave it empty for random-init dev weights")
        if tpu_cfg.spec_k > 0:
            raise NotImplementedError(
                f"llm.tpu.spec_k={tpu_cfg.spec_k}: speculative decoding is "
                "not ported (ROADMAP A4); set LLM_TPU_SPEC_K=0")
        if tpu_cfg.mesh_shape:
            raise NotImplementedError(
                f"llm.tpu.mesh_shape={tpu_cfg.mesh_shape!r}: multi-GPU "
                "serving is not ported (ROADMAP A7)")
        if tenancy is not None and float(tenancy.max_kv_share) < 1.0:
            raise NotImplementedError(
                f"tenancy.max_kv_share={tenancy.max_kv_share}: the prefix "
                "cache it caps is not ported (ROADMAP A3)")
        device = llama.resolve_device(device)
        if device.type == "cuda":
            _build.build_all()
        cfg = PRESETS[tpu_cfg.model]
        model = llama.LlamaModel(cfg, device=device, seed=0)
        tokenizer = ByteTokenizer()
        # Factory, not a single engine: the supervisor rebuilds through this
        # closure after a step-loop death, reusing the weights (which no
        # engine mutates) while the KV pool, allocator and slot table start
        # from baseline.  The engine it replaces gives up its pool first:
        # the supervisor still holds the dead engine while the new one is
        # built, and two pools at once would not fit a card sized for one.
        built: list = []

        def engine_factory() -> InferenceEngine:
            if built:
                built.pop().release_pool()
            engine = InferenceEngine(
                cfg, model, EngineConfig(max_slots=tpu_cfg.max_batch,
                                         num_blocks=tpu_cfg.kv_blocks),
                tokenizer=tokenizer, device=device)
            # Inside the factory: a rebuilt engine without the grammar
            # would refuse every constrained submit.
            cls._install_verdict_grammar(engine, tokenizer)
            built.append(engine)
            return engine

        governor = None
        if tenancy is not None and tenancy.enabled:
            governor = TenantGovernor(
                requests_per_s=tenancy.requests_per_s,
                request_burst=tenancy.request_burst,
                tokens_per_s=tenancy.tokens_per_s,
                token_burst=tenancy.token_burst,
                enforce=tenancy.enforce,
                max_tenants=tenancy.max_tenants)

        return cls(tokenizer=tokenizer, dev_weights=True,
                   engine_factory=engine_factory, lifecycle=lifecycle,
                   governor=governor)

    def _result(self, handle, what: str):
        res = handle.result(timeout=self.GENERATION_TIMEOUT_S)
        if res.finish_reason == "error":
            raise RuntimeError(f"{what} failed: {res.error}")
        return res

    def generate(
        self, prompt: str, max_tokens: int = 512, temperature: float = 0.1,
        slo_class: str = "standard", tenant: str = "",
        top_k: int = 0, top_p: float = 1.0,
    ) -> str:
        """Free-text completion.  ``top_k`` / ``top_p`` reach the engine's
        sampler (``0 < top_k <= sample_topk_cap`` takes the bounded one)."""
        handle = self._submit(
            self.tokenizer.encode(prompt),
            SamplingParams(max_tokens=max_tokens, temperature=temperature,
                           top_k=top_k, top_p=top_p),
            slo_class=slo_class, tenant=tenant,
        )
        res = self._result(handle, "generation")
        self._note_decode_ms(False, len(res.token_ids),
                             res.latency_s, res.ttft_s)
        return self.tokenizer.decode(res.token_ids)

    def generate_constrained(self, prompt: str,
                             temperature: float = 0.0,
                             slo_class: str = "standard",
                             tenant: str = "") -> str:
        """Grammar-constrained decoding: the verdict FSM's per-step logit
        masks run in the engine's sampler on the device, so the token
        stream is the verdict JSON.  Falls back to the base render path
        when no grammar is installed (other tokenizer, small vocab)."""
        if not self.supports_grammar:
            return super().generate_constrained(prompt,
                                                temperature=temperature,
                                                slo_class=slo_class,
                                                tenant=tenant)
        handle = self._submit(
            self.tokenizer.encode(prompt),
            # max_tokens=1 is a floor: submit() raises it to the grammar's
            # longest accepting path so the verdict can always close.
            SamplingParams(max_tokens=1, temperature=temperature,
                           constrained=True),
            slo_class=slo_class, tenant=tenant,
        )
        res = self._result(handle, "constrained generation")
        self._note_decode_ms(True, len(res.token_ids),
                             res.latency_s, res.ttft_s)
        return self.tokenizer.decode(res.token_ids).strip()

    @property
    def supports_grammar(self) -> bool:
        """Grammar swaps need an engine that passed the verdict-grammar
        install gates (byte tokenizer, vocab >= 259)."""
        return getattr(self.engine, "_grammar", None) is not None

    def generate_with_grammar(self, prompt: str, fsm,
                              temperature: float = 0.0,
                              slo_class: str = "standard",
                              tenant: str = "") -> str:
        """Constrained decode under a caller-supplied FSM: save the
        installed verdict grammar, swap in ``fsm``, decode, restore.  The
        swaps run on the step thread (``EngineService.call``, through the
        supervisor when supervised), which moves each table to the
        device."""
        with self._grammar_swap_lock:
            saved = getattr(self.engine, "_grammar", None)
            if saved is None:
                return ""  # the verdict install already refused this engine
            try:
                self._call(lambda e: e.set_grammar(fsm))
            except ValueError as exc:
                logger.warning("grammar rejected by engine: %s", exc)
                return ""
            try:
                handle = self._submit(
                    self.tokenizer.encode(prompt),
                    SamplingParams(max_tokens=1, temperature=temperature,
                                   constrained=True),
                    slo_class=slo_class, tenant=tenant,
                )
                res = handle.result(timeout=self.GENERATION_TIMEOUT_S)
            finally:
                self._call(lambda e: e.set_grammar(saved))
        if res.finish_reason == "error":
            raise RuntimeError(f"grammar generation failed: {res.error}")
        self._note_decode_ms(True, len(res.token_ids),
                             res.latency_s, res.ttft_s)
        return self.tokenizer.decode(res.token_ids).strip()

    def generate_stream(
        self, prompt: str, max_tokens: int = 512, temperature: float = 0.1,
        slo_class: str = "standard", tenant: str = "",
    ):
        """Yield decoded text increments as tokens reach the host.  Decodes
        cumulatively and emits suffixes, so multi-byte characters never
        split."""
        handle = self._submit(
            self.tokenizer.encode(prompt),
            SamplingParams(max_tokens=max_tokens, temperature=temperature),
            slo_class=slo_class, tenant=tenant,
        )
        toks: list[int] = []
        emitted = ""
        try:
            for tok in handle.stream(timeout=self.GENERATION_TIMEOUT_S):
                toks.append(tok)
                text = self.tokenizer.decode(toks)
                # Hold back a trailing replacement char: a multi-byte
                # character split mid-token, which the next token rewrites.
                stable = text[:-1] if text.endswith("�") else text
                if len(stable) > len(emitted) and stable.startswith(emitted):
                    yield stable[len(emitted):]
                    emitted = stable
        except GeneratorExit:
            # The consumer left (client disconnect): stop decoding for it.
            handle.cancel()
            raise
        # Final flush: whatever the full decode has beyond (or instead of)
        # what was streamed.
        if toks:
            text = self.tokenizer.decode(toks)
            if text != emitted:
                common = 0
                limit = min(len(text), len(emitted))
                while common < limit and text[common] == emitted[common]:
                    common += 1
                if common < len(text):
                    yield text[common:]
        res = handle.result(timeout=1.0)
        if res.finish_reason == "error":
            raise RuntimeError(f"generation failed: {res.error}")

class OpenAICompatBackend(LLMBackend):
    """Remote OpenAI-compatible chat endpoint (the reference's configured
    path, config.go:141-145). Kept for deployments that want it; the
    north-star path is LocalEngineBackend.

    Transient failures (HTTP 429/5xx, connection resets, timeouts) are
    retried with exponential backoff so one 502 doesn't fail a diagnosis
    outright; non-transient HTTP errors surface the response body in the
    raised error for debuggability.
    """

    name = "openai"
    max_retries = 3
    backoff_s = 0.5
    _RETRY_STATUS = {429, 500, 502, 503, 504}

    def __init__(self, cfg: LLMConfig) -> None:
        self.cfg = cfg
        if not cfg.base_url:
            raise ValueError("llm.base_url required for the openai provider")

    def _post(self, body: bytes):
        req = urllib.request.Request(
            self.cfg.base_url.rstrip("/") + "/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.cfg.api_key}",
            },
        )
        return urllib.request.urlopen(req, timeout=self.cfg.timeout)

    def generate(
        self, prompt: str, max_tokens: int = 512, temperature: float = 0.1,
        slo_class: str = "standard", tenant: str = "",
    ) -> str:
        # slo_class/tenant ignored: the remote endpoint has its own
        # admission and accounting.
        body = json.dumps(
            {
                "model": self.cfg.model,
                "messages": [{"role": "user", "content": prompt}],
                "max_tokens": max_tokens,
                "temperature": temperature,
            }
        ).encode()
        last_err: Exception | None = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                with self._post(body) as resp:
                    raw = resp.read()
                try:
                    # The envelope (choices/usage) is protocol JSON, not
                    # model text; the text itself goes through the
                    # generate_constrained -> parse_verdict funnel.
                    data = json.loads(raw)  # graftcheck: disable=unconstrained-model-parse -- HTTP envelope
                except ValueError as exc:
                    # 200 + non-JSON body (an LB/proxy error page): as
                    # transient as a 502, and must not surface as a
                    # caller-side validation error.
                    raise urllib.error.URLError(
                        f"non-JSON response from LLM endpoint: "
                        f"{raw[:200]!r} ({exc})") from exc
                return data["choices"][0]["message"]["content"]
            except urllib.error.HTTPError as exc:
                detail = ""
                try:
                    detail = exc.read().decode(errors="replace")[:500]
                except Exception:  # noqa: BLE001
                    pass
                last_err = RuntimeError(
                    f"LLM endpoint returned {exc.code}: {detail or exc.reason}")
                if exc.code not in self._RETRY_STATUS:
                    raise last_err from exc
                logger.warning("LLM request failed (%s), attempt %d/%d",
                               exc.code, attempt + 1, self.max_retries + 1)
            except (urllib.error.URLError, TimeoutError, OSError,
                    http.client.HTTPException) as exc:
                # HTTPException covers mid-body failures (IncompleteRead,
                # RemoteDisconnected) that are not OSError subclasses.
                last_err = RuntimeError(f"LLM endpoint unreachable: {exc}")
                logger.warning("LLM request failed (%s), attempt %d/%d",
                               exc, attempt + 1, self.max_retries + 1)
        raise last_err  # type: ignore[misc]



def build_backend(cfg: LLMConfig,
                  lifecycle: LifecycleConfig | None = None,
                  tenancy=None, *, device=None) -> LLMBackend:
    """The backend ``cfg.provider`` names.  ``"tpu"`` is the in-tree engine
    (the port's, on ``device``: ``cuda`` unless the caller asks for the
    CPU); it does not fall back to the template backend when it cannot be
    built, so a missing card or an unported knob fails the boot."""
    if cfg.provider == "tpu":
        return LocalEngineBackend.from_config(cfg.tpu, lifecycle=lifecycle,
                                              tenancy=tenancy, device=device)
    if cfg.provider == "openai":
        try:
            return OpenAICompatBackend(cfg)
        except ValueError as exc:
            logger.warning("openai backend misconfigured (%s); using template", exc)
            return TemplateBackend()
    return TemplateBackend()


# ---------------------------------------------------------------------------
# evidence assembly
# ---------------------------------------------------------------------------


class EvidenceCollector:
    """Bounded cluster evidence → prompt sections.

    The bound is ``analysis.max_context_events`` (ref config.go:94) applied
    to the event stream; metric sections are already summaries.
    """

    def __init__(
        self,
        client: Client | None,
        manager: Manager | None,
        cfg: AnalysisConfig | None = None,
    ) -> None:
        self.client = client
        self.manager = manager
        self.cfg = cfg or AnalysisConfig()

    def collect(
        self,
        namespace: str | None = None,
        pod: str | None = None,
        include_logs: bool = False,
    ) -> dict[str, Any]:
        """Structured evidence dict; ``format_prompt`` renders it."""
        ev: dict[str, Any] = {"collected_at": utcnow().isoformat()}
        if self.manager is not None:
            snap = self.manager.get_latest_snapshot()
            if snap.cluster_metrics is not None:
                ev["cluster"] = to_jsonable(snap.cluster_metrics)
            ev["unhealthy_nodes"] = [
                {"node": n.node_name, "conditions": n.conditions,
                 "cpu_pct": round(n.cpu_usage_rate, 1),
                 "mem_pct": round(n.memory_usage_rate, 1)}
                for n in snap.node_metrics.values()
                if not n.healthy or n.is_under_pressure()
            ]
            ev["problem_pods"] = [
                {"pod": key, "phase": p.phase, "ready": p.ready,
                 "restarts": p.restarts,
                 "over_limit": p.is_over_limit()}
                for key, p in snap.pod_metrics.items()
                if p.phase != "Running" or not p.ready or p.is_over_limit()
                or p.restarts > 3
            ]
            ev["network_issues"] = [
                {"pair": f"{m.source_pod} -> {m.target_pod}",
                 "connected": m.connected, "rtt_ms": round(m.rtt_ms, 2),
                 "quality": m.quality(), "error": m.error}
                for m in snap.network_metrics
                if not m.connected or m.quality() in ("fair", "poor")
            ]
            uavs = self.manager.get_uav_metrics()
            low = []
            for node, entry in uavs.items():
                state = entry.get("state") or {}
                batt = state.get("battery", {}) if isinstance(state, dict) else {}
                pct = batt.get("remaining_percent")
                if pct is not None and pct < 20.0:
                    low.append({"node": node, "battery_pct": pct})
            if low:
                ev["low_battery_uavs"] = low
        if self.client is not None:
            events = []
            try:
                for ns in self.client.namespaces():
                    for e in self.client.get_events(
                        ns, limit=self.cfg.max_context_events
                    ):
                        events.append(
                            {"ns": ns, "type": e.type, "reason": e.reason,
                             "message": e.message, "count": e.count}
                        )
            except ClusterError as exc:
                logger.warning("event collection failed: %s", exc)
            warnings = [e for e in events if e["type"] == "Warning"]
            ev["recent_warning_events"] = warnings[-self.cfg.max_context_events :]
            if pod and namespace and include_logs:
                try:
                    ev["pod_logs"] = self.client.get_pod_logs(
                        namespace, pod, tail_lines=40
                    )
                except ClusterError as exc:
                    ev["pod_logs"] = f"<unavailable: {exc}>"
        return ev

    @staticmethod
    def format_prompt(evidence: dict[str, Any]) -> str:
        """Render evidence into the markdown-ish prompt body."""
        lines: list[str] = []
        cluster = evidence.get("cluster")
        if cluster:
            lines.append("## Cluster health")
            lines.append(
                f"status={cluster.get('health_status')} nodes="
                f"{cluster.get('healthy_nodes')}/{cluster.get('total_nodes')} "
                f"pods_running={cluster.get('running_pods')}/{cluster.get('total_pods')} "
                f"cpu={cluster.get('cpu_usage_rate', 0):.1f}% "
                f"mem={cluster.get('memory_usage_rate', 0):.1f}%"
            )
            for issue in cluster.get("issues", []) or []:
                lines.append(f"- {issue}")
        for key, title in (
            ("unhealthy_nodes", "Unhealthy nodes"),
            ("problem_pods", "Problem pods"),
            ("network_issues", "Network issues"),
            ("low_battery_uavs", "Low-battery UAVs"),
            ("recent_warning_events", "Recent warning events"),
        ):
            items = evidence.get(key)
            if items:
                lines.append(f"## {title}")
                for item in items:
                    lines.append(f"- {json.dumps(item, default=str)}")
        logs = evidence.get("pod_logs")
        if logs:
            lines.append("## Pod logs (tail)")
            lines.append(str(logs))
        if len(lines) == 0:
            lines.append("## Cluster health")
            lines.append("No evidence available (cluster unreachable or empty).")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the analysis engine
# ---------------------------------------------------------------------------

_SYSTEM_PREAMBLE = (
    "You are a Kubernetes SRE assistant analyzing live cluster monitoring "
    "evidence. Answer with a concise diagnosis and concrete remediation "
    "steps grounded ONLY in the evidence sections below.\n"
)


class AnalysisEngine:
    def __init__(
        self,
        backend: LLMBackend,
        client: Client | None = None,
        manager: Manager | None = None,
        cfg: AnalysisConfig | None = None,
        llm_cfg: LLMConfig | None = None,
        anomaly_detector=None,
    ) -> None:
        self.backend = backend
        self.client = client
        self.manager = manager
        self.cfg = cfg or AnalysisConfig()
        self.llm_cfg = llm_cfg or LLMConfig()
        self.evidence = EvidenceCollector(client, manager, self.cfg)
        # analysis.anomaly.EmbeddingAnomalyDetector (optional): adds
        # content-aware outlier detection over event text to the
        # thresholds-only anomaly signals.
        self.anomaly_detector = anomaly_detector
        # Multi-turn follow-up sessions (diagnosis/session.py); build_server
        # replaces this with one sized from config.diagnosis.
        self.sessions = SessionManager()

    # -- free-form NL question (the missing /api/v1/query) ---------------------

    def query(self, question: str, slo_class: str = "interactive",
              tenant: str = "") -> AnalysisResponse:
        request_id = uuid.uuid4().hex[:12]
        try:
            ev = self.evidence.collect()
            prompt = (
                _SYSTEM_PREAMBLE
                + self.evidence.format_prompt(ev)
                + f"\n## Question\n{question}\n## Answer\n"
            )
            answer = self.backend.generate(
                prompt,
                max_tokens=self.llm_cfg.max_tokens,
                temperature=self.llm_cfg.temperature,
                slo_class=slo_class,
                tenant=tenant,
            )
            return AnalysisResponse(
                request_id=request_id,
                status="success",
                result={
                    "answer": answer,
                    "model": self.backend.name,
                    "evidence": ev,
                },
            )
        except OverloadedError:
            # Admission-control pushback is not an internal failure: let it
            # propagate to the HTTP layer, which maps it to 429/503 with a
            # Retry-After hint and queue evidence.
            raise
        except Exception as exc:  # noqa: BLE001 — API boundary
            logger.exception("query failed")
            return AnalysisResponse(
                request_id=request_id,
                status="error",
                error=str(exc),
                error_kind="internal",
            )

    def query_stream(self, question: str, slo_class: str = "interactive",
                     tenant: str = ""):
        """Streaming variant of query(): returns (request_id, model_name,
        iterator of answer-text chunks).  Evidence collection happens up
        front (before the first chunk); generation streams from the backend
        as tokens come off the device (LocalEngineBackend) or as one chunk
        (backends without true streaming)."""
        request_id = uuid.uuid4().hex[:12]
        ev = self.evidence.collect()
        prompt = (
            _SYSTEM_PREAMBLE
            + self.evidence.format_prompt(ev)
            + f"\n## Question\n{question}\n## Answer\n"
        )
        chunks = self.backend.generate_stream(
            prompt,
            max_tokens=self.llm_cfg.max_tokens,
            temperature=self.llm_cfg.temperature,
            slo_class=slo_class,
            tenant=tenant,
        )
        return request_id, self.backend.name, chunks

    def query_session(self, question: str, session_id: str = "",
                      slo_class: str = "interactive",
                      tenant: str = "") -> AnalysisResponse:
        """Multi-turn variant of ``query``: the cluster context is frozen
        at session creation and replayed verbatim as the prompt prefix on
        every follow-up, so the engine's PrefixCache (and fleet prefix
        affinity) serve the shared context instead of re-prefilling it.
        An empty ``session_id`` mints a new session; the id comes back in
        the result for the next turn."""
        request_id = uuid.uuid4().hex[:12]
        try:
            session, created = self.sessions.get_or_create(
                session_id,
                lambda: self.evidence.format_prompt(
                    self.evidence.collect()) + "\n",
            )
            prompt = session.build_prompt(_SYSTEM_PREAMBLE, question)
            answer = self.backend.generate(
                prompt,
                max_tokens=self.llm_cfg.max_tokens,
                temperature=self.llm_cfg.temperature,
                slo_class=slo_class,
                tenant=tenant,
            )
            session.record(question, answer)
            return AnalysisResponse(
                request_id=request_id,
                status="success",
                result={
                    "answer": answer,
                    "model": self.backend.name,
                    "session_id": session.session_id,
                    "session_created": created,
                    "turn": len(session.turns),
                },
            )
        except OverloadedError:
            raise  # mapped to 429/503 + Retry-After at the HTTP layer
        except Exception as exc:  # noqa: BLE001 — API boundary
            logger.exception("session query failed")
            return AnalysisResponse(
                request_id=request_id,
                status="error",
                error=str(exc),
                error_kind="internal",
            )

    # -- grammar-constrained verdicts -------------------------------------------

    def diagnose(self, question: str, context: str | None = None,
                 slo_class: str = "standard",
                 tenant: str = "") -> dict[str, Any]:
        """One grammar-constrained root-cause verdict as a parsed dict.

        The contract callers (pipeline, ``_analyze_root_cause``) rely on:
        the return value ALWAYS matches ``diagnosis.grammar.VERDICT_SCHEMA``
        — keys severity/component/root_cause/recommendation/confidence.
        ``context`` is pre-rendered evidence text (the pipeline passes its
        assembled burst context); when omitted, live cluster evidence is
        collected.
        """
        if context is None:
            context = self.evidence.format_prompt(self.evidence.collect())
        prompt = (
            _SYSTEM_PREAMBLE
            + context
            + f"\n## Question\n{question}\n"
            "## Verdict\nRespond with exactly one JSON object with keys "
            "severity, component, root_cause, recommendation, confidence:\n"
        )
        text = self.backend.generate_constrained(
            prompt, temperature=self.llm_cfg.temperature,
            slo_class=slo_class, tenant=tenant)
        try:
            return parse_verdict(text)
        except GrammarError as exc:
            # Defense in depth: the FSM makes this unreachable for the
            # constrained engine path, but a misbehaving custom backend
            # must not break the always-parses contract.
            logger.warning("backend emitted grammar-invalid verdict: %s", exc)
            return parse_verdict(render_verdict(
                "warning", "cluster", text,
                "re-run the diagnosis", 0.2))

    # -- typed analyses (ref pkg/models/models.go:85-99) ------------------------

    def analyze(self, request: AnalysisRequest,
                tenant: str = "") -> AnalysisResponse:
        request_id = uuid.uuid4().hex[:12]
        if request.type not in ANALYSIS_TYPES:
            return AnalysisResponse(
                request_id=request_id,
                status="error",
                error=f"unknown analysis type {request.type!r}; "
                f"expected one of {list(ANALYSIS_TYPES)}",
                error_kind="validation",
            )
        try:
            handler = {
                "pod_communication": self._analyze_pod_communication,
                "anomaly_detection": self._analyze_anomalies,
                "root_cause": self._analyze_root_cause,
            }[request.type]
            result = handler(request.parameters or {}, tenant)
            return AnalysisResponse(
                request_id=request_id, status="success", result=result
            )
        except ValueError as exc:  # bad parameters from the caller
            return AnalysisResponse(
                request_id=request_id,
                status="error",
                error=str(exc),
                error_kind="validation",
            )
        except OverloadedError:
            raise  # mapped to 429/503 + Retry-After at the HTTP layer
        except Exception as exc:  # noqa: BLE001 — API boundary
            logger.exception("analysis %s failed", request.type)
            return AnalysisResponse(
                request_id=request_id,
                status="error",
                error=str(exc),
                error_kind="internal",
            )

    def _analyze_pod_communication(self, params: dict[str, Any],
                                   tenant: str = "") -> dict[str, Any]:
        pod_a = params.get("pod_a", "")
        pod_b = params.get("pod_b", "")
        if not pod_a or not pod_b:
            raise ValueError("pod_a and pod_b are required")
        if self.client is None:
            raise ClusterError("cluster client unavailable")
        analysis = NetworkAnalyzer(self.client).analyze_pod_communication(pod_a, pod_b)
        findings = "\n".join(f"- {i}" for i in analysis.issues) or "- no issues found"
        prompt = (
            _SYSTEM_PREAMBLE
            + f"## Pod communication check {pod_a} -> {pod_b}\n"
            + f"status={analysis.status} confidence={analysis.confidence}\n"
            + f"## Findings\n{findings}\n"
            + "## Question\nExplain the most likely root cause of any "
            "communication problem between these pods and how to fix it.\n"
            "## Answer\n"
        )
        diagnosis = self.backend.generate(
            prompt, max_tokens=self.llm_cfg.max_tokens,
            temperature=self.llm_cfg.temperature,
            tenant=tenant,
        )
        return {
            "analysis": to_jsonable(analysis),
            "llm_diagnosis": diagnosis,
            "model": self.backend.name,
        }

    def _analyze_anomalies(self, params: dict[str, Any],
                           tenant: str = "") -> dict[str, Any]:
        ev = self.evidence.collect()
        anomalies: list[str] = []
        anomalies += [
            f"node {n['node']} unhealthy/pressured (cpu {n['cpu_pct']}%, "
            f"mem {n['mem_pct']}%, conditions {n['conditions']})"
            for n in ev.get("unhealthy_nodes", [])
        ]
        anomalies += [
            f"pod {p['pod']} {p['phase']} ready={p['ready']} "
            f"restarts={p['restarts']} over_limit={p['over_limit']}"
            for p in ev.get("problem_pods", [])
        ]
        anomalies += [
            f"network {m['pair']}: connected={m['connected']} "
            f"quality={m['quality']}"
            for m in ev.get("network_issues", [])
        ]
        anomalies += [
            f"UAV on {u['node']} battery {u['battery_pct']}%"
            for u in ev.get("low_battery_uavs", [])
        ]
        embedding_outliers: list[dict[str, Any]] = []
        if self.anomaly_detector is not None:
            events = ev.get("recent_warning_events", [])
            texts = [f"{e.get('reason', '')}: {e.get('message', '')}"
                     for e in events]
            try:
                for idx, score in self.anomaly_detector.flag_outliers(texts):
                    embedding_outliers.append(
                        {"event": texts[idx], "score": round(score, 4)})
                    anomalies.append(
                        f"semantic outlier event (score {score:.2f}): "
                        f"{texts[idx]}")
            except Exception as exc:  # noqa: BLE001 — detector is best-effort
                logger.warning("embedding anomaly scoring failed: %s", exc)
        prompt = (
            _SYSTEM_PREAMBLE
            + self.evidence.format_prompt(ev)
            + "\n## Question\nSummarize the anomalies, rank them by severity, "
            "and recommend the first remediation step for each.\n## Answer\n"
        )
        summary = self.backend.generate(
            prompt, max_tokens=self.llm_cfg.max_tokens,
            temperature=self.llm_cfg.temperature,
            tenant=tenant,
        )
        return {
            "anomalies": anomalies,
            "anomaly_count": len(anomalies),
            "embedding_outliers": embedding_outliers,
            "llm_summary": summary,
            "model": self.backend.name,
        }

    def _analyze_root_cause(self, params: dict[str, Any],
                            tenant: str = "") -> dict[str, Any]:
        namespace = params.get("namespace", "default")
        pod = params.get("pod", "")
        symptom = params.get("symptom", "") or params.get("question", "")
        ev = self.evidence.collect(
            namespace=namespace, pod=pod or None, include_logs=bool(pod)
        )
        target = f"pod {namespace}/{pod}" if pod else "the cluster"
        prompt = (
            _SYSTEM_PREAMBLE
            + self.evidence.format_prompt(ev)
            + f"\n## Question\nPerform a root-cause analysis for {target}."
            + (f" Reported symptom: {symptom}." if symptom else "")
            + " Identify the most probable cause chain and the fix.\n## Answer\n"
        )
        answer = self.backend.generate(
            prompt, max_tokens=self.llm_cfg.max_tokens,
            temperature=self.llm_cfg.temperature,
            tenant=tenant,
        )
        verdict = self.diagnose(
            f"Root-cause analysis for {target}."
            + (f" Reported symptom: {symptom}." if symptom else ""),
            context=self.evidence.format_prompt(ev),
            tenant=tenant,
        )
        return {
            "target": target,
            "root_cause_analysis": answer,
            "verdict": verdict,
            "evidence": ev,
            "model": self.backend.name,
        }
