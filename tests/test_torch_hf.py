"""Local HF checkpoints in the port: its own safetensors reader and
writer against the reference's `transformers` path.

Tiny `transformers` models of each family (no download) are saved
with `save_pretrained` as one `model.safetensors` and as sharded files
with an index (and once as `pytorch_model.bin`). Pinned: the port's
`load_hf_checkpoint` gives exactly `params_from_jax` of the reference's
`load_hf_checkpoint` (which loads through `transformers`), with
`transformers` and `safetensors` blocked in `sys.modules` (Mixtral's
per-expert and DBRX's fused expert layouts among them); vocab padding;
the leftover-tensor refusal; and `export_hf_checkpoint`
(config.json and safetensors written by the port) reloading in
`transformers` with logits equal to the port's (within the reference's
own HF tolerance, tests/test_convert.py's 3e-4), and back through the
port's loader bit for bit.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip('transformers')

from skypilot_tpu.models.configs import ModelConfig as JaxModelConfig  # noqa: E402
from skypilot_tpu.models.convert import (  # noqa: E402
    load_hf_checkpoint as jax_load_hf_checkpoint)
from skypilot_tpu_torch.models import convert  # noqa: E402
from skypilot_tpu_torch.models import safetensors_file  # noqa: E402
from skypilot_tpu_torch.models.configs import ModelConfig  # noqa: E402
from skypilot_tpu_torch.models.transformer import Transformer  # noqa: E402

HF_ATOL = 3e-4
_COMMON = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               max_position_embeddings=64, attn_implementation='eager')


def _cfg(**kw):
    base = dict(name='hf-test', vocab_size=256, d_model=64, num_layers=2,
                num_heads=4, num_kv_heads=2, d_mlp=128, max_seq_len=64,
                rope_theta=10000.0, norm_eps=1e-6, attention_impl='xla',
                remat=False, dtype='float32', param_dtype='float32')
    base.update(kw)
    return base


def _llama():
    return (transformers.LlamaForCausalLM(transformers.LlamaConfig(
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6,
        **_COMMON)), _cfg())


def _mistral():
    return (transformers.MistralForCausalLM(transformers.MistralConfig(
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6,
        sliding_window=8, **_COMMON)), _cfg(sliding_window=8))


def _qwen2():
    return (transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6,
        **_COMMON)), _cfg(qkv_bias=True))


def _gemma():
    return (transformers.GemmaForCausalLM(transformers.GemmaConfig(
        num_key_value_heads=1, head_dim=32, rope_theta=10000.0,
        rms_norm_eps=1e-6, **_COMMON)),
            _cfg(num_kv_heads=1, head_dim_override=32,
                 mlp_activation='gelu', norm_style='rms_plus1',
                 tie_embeddings=True, scale_embed_by_dim=True,
                 vocab_size=384, unpadded_vocab_size=256))


def _phi():
    common = dict(_COMMON)
    return (transformers.PhiForCausalLM(transformers.PhiConfig(
        num_key_value_heads=4, rope_theta=10000.0,
        partial_rotary_factor=0.5, **common)),
            _cfg(num_kv_heads=4, mlp_style='plain', mlp_activation='gelu',
                 norm_style='layernorm', parallel_block=True, qkv_bias=True,
                 o_bias=True, mlp_bias=True, lm_head_bias=True,
                 rotary_pct=0.5, norm_eps=1e-5))


def _falcon():
    return (transformers.FalconForCausalLM(transformers.FalconConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, ffn_hidden_size=128,
        max_position_embeddings=64, rope_theta=10000.0,
        layer_norm_epsilon=1e-6, multi_query=True, parallel_attn=True,
        bias=False, alibi=False, new_decoder_architecture=False,
        tie_word_embeddings=True, attn_implementation='eager')),
            _cfg(num_kv_heads=1, mlp_style='plain', mlp_activation='gelu',
                 norm_style='layernorm', tie_embeddings=True,
                 parallel_block=True))


def _gpt2():
    return (transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=96, n_embd=48, n_layer=2, n_head=4, n_positions=80,
        attn_implementation='eager')),
            _cfg(vocab_size=128, unpadded_vocab_size=96, d_model=48,
                 num_kv_heads=4, d_mlp=192, mlp_activation='gelu',
                 mlp_style='plain', norm_style='layernorm',
                 pos_embedding='learned', qkv_bias=True, o_bias=True,
                 mlp_bias=True, tie_embeddings=True, norm_eps=1e-5))


def _mixtral():
    # moe_impl='dense': HF routes without capacity (no drops), as the
    # reference's own HF parity tests set it (tests/test_convert.py).
    return (transformers.MixtralForCausalLM(transformers.MixtralConfig(
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6,
        num_local_experts=4, num_experts_per_tok=2, **_COMMON)),
            _cfg(num_experts=4, experts_per_token=2, moe_impl='dense'))


def _dbrx():
    return (transformers.DbrxForCausalLM(transformers.DbrxConfig(
        d_model=64, n_heads=4, n_layers=2, max_seq_len=64, vocab_size=256,
        attn_config={'kv_n_heads': 2, 'rope_theta': 10000.0,
                     'clip_qkv': 8.0},
        ffn_config={'ffn_hidden_size': 128, 'moe_num_experts': 4,
                    'moe_top_k': 2},
        attn_implementation='eager')),
            _cfg(num_experts=4, experts_per_token=2, moe_impl='dense',
                 norm_style='layernorm', norm_bias=False, qkv_clip=8.0,
                 norm_eps=1e-5))


FAMILIES = {'llama': _llama, 'mistral': _mistral, 'qwen2': _qwen2,
            'gemma': _gemma, 'phi': _phi, 'falcon': _falcon, 'gpt2': _gpt2,
            'mixtral': _mixtral, 'dbrx': _dbrx}


def _build(family, seed=0):
    torch.manual_seed(seed)
    model, kw = FAMILIES[family]()
    with torch.no_grad():                  # biases and norms off their init
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model.eval(), kw


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize('layout', ['single', 'sharded'])
@pytest.mark.parametrize('family', list(FAMILIES))
def test_loader_equals_reference_without_transformers(family, layout,
                                                      tmp_path, monkeypatch):
    model, kw = _build(family)
    path = str(tmp_path / 'hf')
    model.save_pretrained(path, max_shard_size='20KB'
                          if layout == 'sharded' else '5GB')
    index = os.path.exists(os.path.join(path,
                                        safetensors_file.INDEX_FILE))
    assert index == (layout == 'sharded')
    tree = jax_load_hf_checkpoint(path, JaxModelConfig(**kw))
    want = convert.params_from_jax(tree, ModelConfig(**kw))
    monkeypatch.setitem(sys.modules, 'transformers', None)
    monkeypatch.setitem(sys.modules, 'safetensors', None)
    got = convert.load_hf_checkpoint(path, ModelConfig(**kw))
    _assert_state_equal(got, want)


def test_loader_reads_pytorch_bin_and_casts(tmp_path):
    model, kw = _build('qwen2')
    path = str(tmp_path / 'bin')
    model.save_pretrained(path, safe_serialization=False)
    assert os.path.exists(os.path.join(path, 'pytorch_model.bin'))
    cfg = ModelConfig(**kw)
    got = convert.load_hf_checkpoint(path, cfg, dtype='bfloat16')
    want = convert.from_hf(model.state_dict(), cfg, dtype='bfloat16')
    _assert_state_equal(got, want)
    assert got['layers.1.attn.qkv_proj_bias'].dtype == torch.bfloat16


def test_leftover_tensor_and_moe_refused():
    model, kw = _build('llama')
    sd = dict(model.state_dict())
    sd['model.layers.0.post_feedforward_layernorm.weight'] = torch.ones(64)
    with pytest.raises(ValueError, match='does not consume'):
        convert.from_hf(sd, ModelConfig(**kw))
    qwen, kw = _build('qwen2')
    with pytest.raises(ValueError, match='does not consume'):
        convert.from_hf(qwen.state_dict(), ModelConfig(**dict(
            kw, qkv_bias=False)))
    gpt2, kw = _build('gpt2')
    with pytest.raises(ValueError, match='positions'):
        convert.from_hf(gpt2.state_dict(), ModelConfig(**dict(
            kw, max_seq_len=128)))
    # MoE layouts load (FAMILIES' mixtral and dbrx); a Mixtral checkpoint
    # with more experts than the config leaves its last expert unread.
    mixtral, kw = _build('mixtral')
    with pytest.raises(ValueError, match='does not consume'):
        convert.from_hf(mixtral.state_dict(), ModelConfig(**dict(
            kw, num_experts=3)))


def _port_logits(state, cfg, tokens):
    model = Transformer(cfg, device='cpu')
    model.load_state_dict(state, assign=True)
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize('family', list(FAMILIES))
def test_export_reloads_in_transformers(family, tmp_path):
    model, kw = _build(family, seed=1)
    cfg = ModelConfig(**kw)
    state = convert.from_hf(model.state_dict(), cfg)
    out = str(tmp_path / 'export')
    files = convert.export_hf_checkpoint(state, cfg, out,
                                         max_shard_bytes=64 << 10)
    assert safetensors_file.INDEX_FILE in files       # sharded
    with open(os.path.join(out, 'config.json'), encoding='utf-8') as f:
        assert json.load(f)['torch_dtype'] == 'float32'
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        out, attn_implementation='eager').eval()
    vocab = cfg.unpadded_vocab_size or cfg.vocab_size
    tokens = np.random.RandomState(2).randint(0, vocab, (1, 12))
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.numpy()
    got = _port_logits(state, cfg, tokens)[..., :vocab]
    np.testing.assert_allclose(got, want, atol=HF_ATOL, rtol=HF_ATOL)
    # And back through the port's own reader, bit for bit.
    _assert_state_equal(convert.load_hf_checkpoint(out, cfg), state)


def test_hf_config_refusals():
    with pytest.raises(NotImplementedError, match='softcap'):
        convert.hf_config_for(ModelConfig(**_cfg(attn_logit_softcap=30.0)))
    with pytest.raises(ValueError, match='serving format'):
        convert.to_hf({}, ModelConfig(**_cfg(weight_quant='int8')))
