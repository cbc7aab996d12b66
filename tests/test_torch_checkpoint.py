"""HF checkpoints on disk through the port's loader, against the JAX
package's loader and ``transformers`` on the CPU.

Two tiny checkpoints are written by ``transformers.save_pretrained`` (no
download): a Llama as index-sharded float32 safetensors, and a Qwen2 (QKV
biases, 14 query heads over 2 kv heads: 7 per kv head) as one bfloat16
file, each beside an in-code word-level tokenizer.

  * ``config_from_hf`` gives the JAX package's fields (the Qwen2 sliding
    rule included; Gemma-2, Mixtral and Mistral v0.1's window, ROADMAP
    A9, too);
  * the loaded weights, bf16 and int8, equal the JAX package's
    ``load_hf_checkpoint`` through ``params_from_jax``, bit for bit;
  * float32 greedy ids of the port's engine equal ``transformers.generate``
    and the JAX engine on the loaded weights;
  * ``HFTokenizer`` encodes as the JAX package's and round-trips text;
  * the port's own safetensors reader returns what the ``safetensors``
    package wrote (F32, F16, BF16, I8) bit for bit;
  * ``save_checkpoint`` / ``restore_checkpoint`` round-trip bf16 and int8
    models;
  * ``LocalEngineBackend.from_config`` with a checkpoint (bf16, int8 and
    W8A8) answers ``generate`` on the CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils import checkpoint as jckpt
from k8s_llm_monitor_tpu.utils.tokenizer import HFTokenizer as JHFTokenizer
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.monitor import analysis
from k8s_llm_monitor_tpu_torch.monitor.config import TPULLMConfig
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils import checkpoint as tckpt
from k8s_llm_monitor_tpu_torch.utils.tokenizer import HFTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORDS = (
    "pod service node event warning error restart backoff oom killed "
    "pending running failed ready probe liveness readiness image pull "
    "dns resolve network policy deny allow traffic latency high low "
    "the a is was not can cannot reach because of on in to from and "
    "web db cache api frontend backend default kube system container "
    "crashloop evicted taint toleration affinity replica deployment"
).split()
PROMPT = ("the web pod is not ready because the image pull failed "
          "and the dns resolve")
_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]


def _save_tokenizer(path):
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>").save_pretrained(path)


def _randomize(model, scale):
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * scale)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{name: (model dir, the float32 HF model holding the saved values)}:
    a sharded f32 Llama and a one-file bf16 Qwen2, each directory with its
    tokenizer."""
    import transformers

    root = tmp_path_factory.mktemp("ckpt")
    common = dict(vocab_size=128, max_position_embeddings=256,
                  rms_norm_eps=1e-5, tie_word_embeddings=False,
                  attn_implementation="eager", bos_token_id=1,
                  eos_token_id=2)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        hidden_size=64, intermediate_size=160, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0,
        **common)).eval()
    _randomize(llama, 0.05)
    llama.save_pretrained(root / "llama", max_shard_size="50KB",
                          safe_serialization=True)
    assert (root / "llama" / "model.safetensors.index.json").exists()
    qwen = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        hidden_size=112, intermediate_size=160, num_hidden_layers=2,
        num_attention_heads=14, num_key_value_heads=2, rope_theta=1e6,
        use_sliding_window=False, **common)).eval()
    _randomize(qwen, 0.05)
    qwen.to(torch.bfloat16).save_pretrained(root / "qwen2",
                                            safe_serialization=True)
    assert not (root / "qwen2" / "model.safetensors.index.json").exists()
    qwen.float()                      # the saved bf16 values, in float32
    for d in ("llama", "qwen2"):
        _save_tokenizer(root / d)
    return {"llama": (root / "llama", llama), "qwen2": (root / "qwen2", qwen)}


def _fields(cfg):
    return {f: getattr(cfg, f) for f in _FIELDS if f != "name"}


@pytest.mark.parametrize("which", ["llama", "qwen2"])
def test_config_from_saved_checkpoint_matches_jax(checkpoints, which):
    hf = json.loads((checkpoints[which][0] / "config.json").read_text())
    got = tckpt.config_from_hf(hf)
    assert _fields(got) == _fields(jckpt.config_from_hf(hf))
    assert got.qkv_bias == (which == "qwen2")
    assert got.q_per_kv == (7 if which == "qwen2" else 2)


HF_CONFIGS = {
    # Qwen2 ships a window beside use_sliding_window: false.
    "qwen2-window-off": dict(model_type="qwen2", sliding_window=131072,
                             use_sliding_window=False, max_window_layers=28),
    "mistral-v0.3": dict(model_type="mistral", sliding_window=None,
                         rope_theta=1e6, head_dim=128),
    "llama3.1-rope": dict(model_type="llama", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}),
    # ROADMAP A9: Gemma-2 (its class defaults: a 4,096 window over
    # alternating layers, caps 50 / 30, query scale 256**-0.5, tied
    # embeddings), Mixtral's experts, Mistral v0.1's live window.
    "gemma2": dict(model_type="gemma2", head_dim=256),
    "mixtral": dict(model_type="mixtral", num_local_experts=8,
                    num_experts_per_tok=2),
    "mistral-v0.1": dict(model_type="mistral", sliding_window=4096),
}
# The configs whose attention takes the extras (a window, a cap or a
# query scale): dense prefill and the gather, as in the JAX package.
EXTRAS = {"gemma2": 4096, "mistral-v0.1": 4096}
BASE = dict(vocab_size=320, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
            rms_norm_eps=1e-6, max_position_embeddings=4096)


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax(name):
    hf = dict(BASE, **HF_CONFIGS[name])
    got = tckpt.config_from_hf(hf, name=name)
    want = jckpt.config_from_hf(hf, name=name)
    assert got.name == want.name and _fields(got) == _fields(want)
    assert got.sliding_window == EXTRAS.get(name, 0)
    assert got.has_attn_extras == (name in EXTRAS)
    assert got.num_experts == (8 if name == "mixtral" else 0)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("which", ["llama", "qwen2"])
def test_loaded_weights_equal_jax_loader(checkpoints, which, quantize):
    path = checkpoints[which][0]
    jcfg, tree = jckpt.load_hf_checkpoint(path, quantize=quantize)
    cfg, model = tckpt.load_hf_checkpoint(path, quantize=quantize,
                                          device="cpu")
    assert _fields(cfg) == _fields(jcfg) and cfg.dtype == "bfloat16"
    assert model.quantized == quantize
    want = params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                           device="cpu").state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _greedy_hf(hf_model, ids, n):
    with torch.no_grad():
        out = hf_model.generate(torch.tensor([ids]), max_new_tokens=n,
                                do_sample=False, eos_token_id=2,
                                pad_token_id=0)
    new = out[0, len(ids):].tolist()
    return new[:-1] if new and new[-1] == 2 else new


@pytest.mark.parametrize("which", ["llama", "qwen2"])
def test_greedy_ids_match_transformers_and_jax(checkpoints, which):
    path, hf_model = checkpoints[which]
    tok = HFTokenizer(str(path))
    ids = tok.encode(PROMPT)
    ekw = dict(max_slots=2, num_blocks=32, block_size=16,
               max_blocks_per_seq=8, prefill_buckets=(16, 32),
               prefix_cache_entries=0)
    jcfg, tree = jckpt.load_hf_checkpoint(path, dtype="float32")
    want = jengine.InferenceEngine(
        jcfg, tree, jengine.EngineConfig(**ekw), eos_id=2).generate(
        [ids], jengine.SamplingParams(max_tokens=20))[0].token_ids
    cfg, model = tckpt.load_hf_checkpoint(path, dtype="float32",
                                          device="cpu")
    got = tengine.InferenceEngine(
        cfg, model, tengine.EngineConfig(**ekw), eos_id=2,
        device="cpu").generate(
        [ids], tengine.SamplingParams(max_tokens=20))[0].token_ids
    assert got == want == _greedy_hf(hf_model, ids, 20)
    assert len(got) > 0


def test_hf_tokenizer_round_trip(checkpoints):
    path = str(checkpoints["llama"][0])
    tok, jtok = HFTokenizer(path), JHFTokenizer(path)
    text = "the web pod cannot reach the db service"
    assert tok.encode(text) == jtok.encode(text)
    assert tok.encode(text)[0] == tok.bos_id == 1 and tok.eos_id == 2
    assert tok.decode(tok.encode(text)) == text


def test_reader_matches_the_safetensors_package(tmp_path):
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(
            np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(
            np.float32)).to(torch.bfloat16),
        "i8": torch.from_numpy(rng.integers(-128, 128, (6, 4)).astype(
            np.int8)),
    }
    save_file(tensors, str(tmp_path / "a.safetensors"),
              metadata={"format": "pt"})
    save_file({"second.f32": torch.ones(2)},
              str(tmp_path / "b.safetensors"))
    state = tckpt._SafetensorsDict(tmp_path)
    assert sorted(state) == sorted([*tensors, "second.f32"])
    for k, t in tensors.items():
        got = state[k]
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got.view(torch.uint8) if k != "i8" else got,
                           t.view(torch.uint8) if k != "i8" else t), k
    assert torch.equal(state["second.f32"], torch.ones(2))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_save_restore_round_trip(checkpoints, tmp_path, quantize):
    cfg, model = tckpt.load_hf_checkpoint(checkpoints["qwen2"][0],
                                          quantize=quantize, device="cpu")
    path = tmp_path / "model.pt"
    tckpt.save_checkpoint(path, model)
    _, fresh = tckpt.load_hf_checkpoint(checkpoints["llama"][0],
                                        device="cpu")
    state = tckpt.restore_checkpoint(path)
    assert state.keys() == model.state_dict().keys()
    like = type(model)(cfg, device="cpu", seed=None, quantized=quantize)
    assert tckpt.restore_checkpoint(path, like=like) is like
    for k, t in model.state_dict().items():
        assert torch.equal(like.state_dict()[k], t), k
    with pytest.raises(RuntimeError):
        tckpt.restore_checkpoint(path, like=fresh)   # another geometry


@pytest.mark.parametrize("quantize", ["", "int8", "w8a8"])
def test_from_config_serves_a_checkpoint(checkpoints, quantize):
    path = checkpoints["llama"][0]
    tc = TPULLMConfig(checkpoint=str(path), quantize=quantize, spec_k=0,
                      kv_blocks=64, max_batch=2)
    backend = analysis.LocalEngineBackend.from_config(tc, device="cpu")
    try:
        eng = backend.engine
        assert not backend.name.endswith("-RANDOM-WEIGHTS")
        assert isinstance(backend.tokenizer, HFTokenizer)
        assert eng.model.quantized == bool(quantize)
        assert eng.cfg.act_quant == (quantize == "w8a8")
        text = backend.generate(PROMPT, max_tokens=8, temperature=0.0)
        assert isinstance(text, str)
        assert all(w in WORDS or w == "<unk>" for w in text.split())
    finally:
        backend.supervisor.shutdown(grace_s=1.0)
