"""The Analysis Engine's LLM backends over the port's engine.

The ``LLMBackend`` seam and two of its implementations, as in the JAX
package's ``monitor/analysis.py``:

- ``LocalEngineBackend``: in-process inference through the port's
  ``EngineService`` and ``InferenceEngine``; verdicts are decoded under the
  verdict grammar's token FSM on the device, so they always parse;
- ``TemplateBackend``: a deterministic evidence summarizer (dev mode and
  tests without a model).

``EvidenceCollector``, ``AnalysisEngine``, the remote OpenAI-compatible
backend, ``from_config`` and the supervised (``engine_factory=``) mode come
with the supervisor and the server.
"""

from __future__ import annotations

import logging
import re

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
    GrammarError,
    parse_verdict,
    render_verdict,
    verdict_fsm,
)
from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError
from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams
from k8s_llm_monitor_tpu_torch.serving.service import EngineService
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

__all__ = ["LLMBackend", "LocalEngineBackend", "OverloadedError",
           "TemplateBackend"]

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

    def __init__(self, engine=None, tokenizer=None, *, engine_factory=None,
                 governor=None) -> None:
        """``engine=``: the service wraps the given engine directly, and a
        dead step loop is terminal.  The supervised ``engine_factory=`` mode
        (rebuild and replay) needs the engine supervisor and its journal,
        which the port does not have yet."""
        if engine_factory is not None:
            raise NotImplementedError(
                "LocalEngineBackend(engine_factory=...) needs the engine "
                "supervisor, which the port does not have yet (it comes "
                "with the journal and the server); pass engine= instead")
        if engine is None:
            raise ValueError("LocalEngineBackend needs engine=")
        self.tokenizer = tokenizer
        # resilience.tenancy.TenantGovernor (or None): per-tenant quotas.
        self.governor = governor
        # Before the step thread starts: from then on only it touches the
        # engine.
        if getattr(engine, "_grammar", None) is None:
            self._install_verdict_grammar(engine, tokenizer)
        self._service = EngineService(engine, governor=governor)
        # Decode-rate EMAs (ms/token) behind constrained_decode_overhead_ms.
        self._ema_ms_constrained: float | None = None
        self._ema_ms_free: float | None = None
        # Serializes generate_with_grammar()'s set/decode/restore window.
        self._grammar_swap_lock = make_lock("analysis.grammar_swap")

    @property
    def service(self) -> EngineService:
        return self._service

    @property
    def engine(self):
        return self.service.engine

    def _submit(self, prompt_ids, sampling, slo_class: str = "standard",
                tenant: str = ""):
        return self.service.submit(prompt_ids, sampling,
                                   slo_class=slo_class, tenant=tenant)

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
        swaps run on the step thread (``EngineService.call``), which moves
        each table to the device."""
        with self._grammar_swap_lock:
            saved = getattr(self.engine, "_grammar", None)
            if saved is None:
                return ""  # the verdict install already refused this engine
            try:
                self.service.call(lambda e: e.set_grammar(fsm))
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
                self.service.call(lambda e: e.set_grammar(saved))
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
