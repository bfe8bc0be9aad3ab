"""The port's audio model and its KV-cached serve (models/audiorft.py,
nn/attn.py's cached branch, sampling/audio_caching.py, nn/wquant.py,
``AudioRFTTrainer``) against the JAX package, on the CPU in float32.

JAX params are carried across with ``params_from_jax``; inputs are numpy
from a seed; the sampler's draws are made with ``jax.random`` in the JAX
sampler's split order and handed to the port (``SamplerNoise``), as the
model's are (``return_dict``). Tolerances: forwards atol 1e-4, the ring
state after a forward as in tests/test_torch_port_kv_cache.py (counters
exact, contents 1e-6), the whole sampler max |diff| 1e-3 over at least 10
tokens, losses rtol 1e-5, an int8-weight forward atol 1e-4 of the JAX
int8 forward (the same codes and scales, the same arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import Config as JaxConfig
from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.data.synthetic import get_loader as jax_loader
from owl_audio_exps_tpu.models.audiorft import AudioRFT as JaxAudioRFT
from owl_audio_exps_tpu.nn.kv_cache import KVCache as JaxKVCache
from owl_audio_exps_tpu.nn.wquant import quantize_params_int8 as jax_quantize
from owl_audio_exps_tpu.sampling.audio_caching import (
    AudioCachingSampler as JaxSampler)
from owl_audio_exps_tpu.trainers import get_trainer_cls as jax_trainer_cls
from owl_audio_exps_tpu.trainers.rft_trainer import _stack_accum
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.configs import transformer_config as port_config
from owl_audio_exps_tpu_torch.models import get_core_cls, get_model_cls
from owl_audio_exps_tpu_torch.models.audiorft import AudioRFT, AudioRFTCore
from owl_audio_exps_tpu_torch.nn.kv_cache import KVCache
from owl_audio_exps_tpu_torch.nn.wquant import (quantize_params_int8,
                                                quantized_names)
from owl_audio_exps_tpu_torch.sampling import get_sampler_cls
from owl_audio_exps_tpu_torch.sampling.audio_caching import (
    AudioCachingSampler, SamplerNoise)
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import (AUDIO, MODEL_RNGS, assert_same_state, audio_cores,
                             carried, jax_apply, jax_core, load_jax_params,
                             numpy_params, t)

F32 = jnp.float32
ATOL = 1e-4


def _inputs(seed, b, n):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, 8).astype(np.float32),
            rs.rand(b, n).astype(np.float32))


def test_core_matches_jax():
    _, _, jcore, params, port = audio_cores()
    x, ts = _inputs(0, 2, 12)
    want, _ = jax_apply(jcore, params, x, ts)
    with torch.no_grad():
        got = port(t(x), t(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert get_core_cls("audio_rft") is AudioRFTCore
    assert get_model_cls("audio_rft") is AudioRFT
    assert set(params_from_jax(numpy_params(params), 2)) == \
        set(port.state_dict())


@pytest.mark.parametrize("impl", ["concat", "noconcat"])
@pytest.mark.parametrize("split", ["auto", False])
def test_cached_forwards_match_jax(split, impl):
    """A prefill, fused 2-token forwards committing one token (past the
    ring's wrap), decoding forwards (the local layers gather their window
    from the split ring, or from the single ring through its mirror),
    cached forwards that do not write, and an unfused decoding write, each
    against JAX ``core.apply`` from the same cache state: velocities and
    the new ring state."""
    jcfg, pcfg, jcore, params, port = audio_cores(split_local_cache=split,
                                             cache_attn_impl=impl)
    x, ts = _inputs(3, 2, 14)
    jc = JaxKVCache.from_config(jcfg, 2, capacity_frames=8, dtype=F32)
    pc = KVCache.from_config(pcfg, 2, capacity_frames=8,
                             dtype=torch.float32, device="cpu")
    assert pc.split == (split == "auto")

    def both(sl, **kw):
        nonlocal jc
        want, new = jax_apply(jcore, params, x[:, sl], ts[:, sl],
                              kv_cache=jc, **kw)
        with torch.no_grad():
            got = port(t(x[:, sl]), t(ts[:, sl]), kv_cache=pc, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        if kw.get("write"):
            jc = new
        assert_same_state(jc, pc)
        return got

    both(slice(0, 6), write=True)
    for i in range(6, 10):
        both(slice(i, i + 2), write=True, write_len=1)
        both(slice(i + 1, i + 2), decoding=True)
        both(slice(i + 1, i + 2))
    both(slice(10, 11), write=True, decoding=True)
    assert int(pc.length) == 8 and int(pc.rope_offset) == 11


def test_cached_decode_matches_the_full_forward():
    """Prefill n - 1 tokens, then decode the last: equal to the full causal
    forward's last token (tests/test_models.py)."""
    for decoding in (False, True):
        _, pcfg, _, _, port = audio_cores()
        x, ts = _inputs(3, 2, 12)
        cache = KVCache.from_config(pcfg, 2, capacity_frames=16,
                                    dtype=torch.float32, device="cpu")
        with torch.no_grad():
            full = port(t(x), t(ts))
            port(t(x[:, :11]), t(ts[:, :11]), kv_cache=cache, write=True)
            last = port(t(x[:, 11:]), t(ts[:, 11:]), kv_cache=cache,
                        decoding=decoding)
        torch.testing.assert_close(last[:, 0], full[:, -1], atol=2e-4,
                                   rtol=0)


def test_fused_write_commits_one_token():
    """A 2-token forward with write_len=1 stores the same ring as a
    1-token write (tests/test_fused_write.py), and a finite global window
    is refused under the fused write."""
    _, pcfg, _, _, port = audio_cores()
    x, ts = _inputs(4, 1, 8)
    caches = [KVCache.from_config(pcfg, 1, capacity_frames=16,
                                  dtype=torch.float32, device="cpu")
              for _ in range(2)]
    with torch.no_grad():
        for c in caches:
            port(t(x[:, :6]), t(ts[:, :6]), kv_cache=c, write=True)
        port(t(x[:, 6:8]), t(ts[:, 6:8]), kv_cache=caches[0], write=True,
             write_len=1)
        port(t(x[:, 6:7]), t(ts[:, 6:7]), kv_cache=caches[1], write=True)
    a, b = caches
    assert int(a.length) == int(b.length) == 7
    assert int(a.rope_offset) == int(b.rope_offset) == 7
    for name in ("k", "v", "lk", "lv"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   atol=1e-5, rtol=1e-5)
    pcfg.global_window = 2
    with pytest.raises(ValueError, match="write_len"):
        port(t(x[:, 6:8]), t(ts[:, 6:8]), kv_cache=a, write=True,
             write_len=1)


# ---------------------------------------------------------------- sampler

def jax_draws(key, b, init_len, c, num_tokens) -> SamplerNoise:
    """The JAX sampler's draws: split(key) -> (rng, r_ctx), then per token
    split(rng, 3) -> (rng, r_init, r_renoise), all float32 normals."""
    rng, r_ctx = jax.random.split(key)
    ctx = jax.random.normal(r_ctx, (b, init_len, c), F32)
    init, renoise = [], []
    for _ in range(num_tokens):
        rng, r_init, r_ren = jax.random.split(rng, 3)
        init.append(np.asarray(jax.random.normal(r_init, (b, 1, c), F32)))
        renoise.append(np.asarray(jax.random.normal(r_ren, (b, 1, c), F32)))
    return SamplerNoise(t(ctx), t(np.stack(init)), t(np.stack(renoise)))


SAMPLER_CASES = {
    "fused": (dict(), dict(n_steps=2, num_tokens=10,
                           custom_schedule=[1.0, 0.5], max_window=8), 8),
    "unfused_single_ring": (
        dict(split_local_cache=False),
        dict(n_steps=2, num_tokens=10, custom_schedule=[1.0, 0.5],
             max_window=8, fused_write=False), 8),
    "rolling_evicts": (dict(), dict(n_steps=2, num_tokens=14, max_window=6),
                       9),
    "init_len_1": (dict(), dict(n_steps=3, num_tokens=10), 1),
    "one_step": (dict(), dict(n_steps=1, num_tokens=10, fused_write=False),
                 4),
    "outlives_the_rope_table": (
        dict(n_frames=8, rope_headroom=8, local_window=2),
        dict(n_steps=2, num_tokens=40, custom_schedule=[1.0, 0.5],
             max_window=6), 4),
    "int8_ring": (dict(kv_quant="int8"),
                  dict(n_steps=2, num_tokens=10, max_window=8), 8),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(case):
    over, skw, init_len = SAMPLER_CASES[case]
    _, pcfg, jcore, params, port = audio_cores(n_layers=3, **over)
    x = np.random.RandomState(0).randn(1, init_len, 8).astype(np.float32)
    want = JaxSampler(noise_prev=0.2, **skw)(jcore, params, jnp.asarray(x),
                                             jax.random.key(1))
    sampler = get_sampler_cls("audio_caching")(noise_prev=0.2, **skw)
    assert isinstance(sampler, AudioCachingSampler)
    cut = min(init_len, sampler.window(t(x))[1])
    noise = jax_draws(jax.random.key(1), 1, cut, 8, skw["num_tokens"])
    got = sampler(port, t(x), noise=noise)
    assert tuple(got.shape) == tuple(want.shape)
    assert skw["num_tokens"] >= 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    # a second call reuses the loop's buffers and gives the same tokens
    torch.testing.assert_close(sampler(port, t(x), noise=noise), got,
                               atol=0, rtol=0)


def test_sampler_draws_from_the_generator_and_checks_given_draws():
    _, _, _, _, port = audio_cores(n_layers=2)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 5, 8).astype(
        np.float32))
    sampler = AudioCachingSampler(n_steps=2, num_tokens=4, max_window=6)
    a = sampler(port, x, generator=torch.Generator().manual_seed(3))
    b = sampler.sample_eager(port, x,
                             generator=torch.Generator().manual_seed(3))
    c = sampler(port, x, generator=torch.Generator().manual_seed(4))
    assert a.shape == (2, 9, 8) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="noise.init"):
        sampler(port, x, noise=SamplerNoise(torch.zeros(2, 5, 8),
                                            torch.zeros(3, 2, 1, 8),
                                            torch.zeros(4, 2, 1, 8)))
    latents, decoded = sampler(port, x, generator=torch.Generator(),
                               decode_fn=lambda z: z.sum(-1), vae_scale=2.0)
    assert decoded.shape == (2, 9)


# ------------------------------------------------------------------ model

def test_audio_rft_loss_matches_jax():
    kw = dict(AUDIO)
    x, _ = _inputs(5, 2, 16)
    model, params = jax_core(JaxAudioRFT, jax_config(**kw), x,
                             rngs=MODEL_RNGS)
    out = jax_apply(model, params, x, return_dict=True,
                    rngs={"noise": jax.random.key(2)})
    port = AudioRFT(port_config(**kw), dtype=torch.float32, device="cpu",
                    seed=None)
    load_jax_params(port, params, 2)
    with torch.no_grad():
        loss = port(t(x), ts=t(out["ts"]), z=t(out["z_audio"]))
    np.testing.assert_allclose(float(loss), float(out["diffusion_loss"]),
                               rtol=1e-5)
    g = torch.Generator().manual_seed(7)
    a = port(t(x), generator=g.manual_seed(7))
    assert a.item() == port(t(x), generator=g.manual_seed(7)).item()
    assert a.item() > 0.1


def _audio_train_dict(tmp_path):
    import yaml
    with open("configs/smoke_audio.yml") as f:
        raw = yaml.safe_load(f)
    raw["train"].update(checkpoint_dir=str(tmp_path / "ckpt"),
                        opt_kwargs=dict(lr=1e-3, eps=1e-2), log_interval=1)
    return raw


def test_audio_trainer_step_matches_jax(tmp_path):
    """One optimizer step of AudioRFTTrainer on configs/smoke_audio.yml
    (two micro-batches of 4, AdamW, clip, EMA) against the JAX trainer's
    jitted step on the same synthetic batches, given the JAX step's noise
    draws: loss, metrics and the updated parameters."""
    raw = _audio_train_dict(tmp_path)
    jtr = jax_trainer_cls("audio_rft")(JaxConfig.from_dict(raw))
    jtr.model = JaxAudioRFT(jtr.model_cfg, dtype=F32)
    state = jtr.init_state()
    params0 = numpy_params(state.params)
    kw = raw["train"]["data_kwargs"]
    loader = iter(jax_loader("synthetic_audio_latent", 4, **kw))
    batches = [next(loader), next(loader)]
    rng = jax.random.key(11)
    step = jtr.make_train_step(jtr._wrapped_loss, 2,
                               clip_norm=jtr.grad_clip_norm())
    new_state, metrics_j = step(state, _stack_accum(batches), rng)
    draws = []
    for b, r in zip(batches, jax.random.split(rng, 2)):
        out = jax_apply(jtr.model, {"params": params0},
                        jnp.asarray(b[0]).astype(jnp.bfloat16),
                        return_dict=True, rngs={"noise": r})
        draws.append(dict(ts=t(out["ts"]), z=t(out["z_audio"])))

    ptr = get_trainer_cls("audio_rft")(Config.from_dict(raw), device="cpu")
    assert ptr.accum_steps() == 2
    model = carried(AudioRFT, ptr.model_cfg, {"params": params0})
    pstate = ptr.make_state(model.train())
    forward = model.forward
    model.forward = lambda x, generator=None: forward(x, **draws.pop(0))
    metrics_p = ptr.train_step(pstate, [ptr.to_device(b) for b in batches],
                               torch.Generator(),
                               clip_norm=ptr.grad_clip_norm())
    assert not draws
    assert set(metrics_p) == set(metrics_j)
    for key, value in metrics_j.items():
        np.testing.assert_allclose(float(metrics_p[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    want = params_from_jax(numpy_params(new_state.params), 2)
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_audio_trainer_trains_samples_and_refuses_the_vae(tmp_path):
    raw = _audio_train_dict(tmp_path)
    raw["train"]["save_interval"] = 1000
    tr = get_trainer_cls("audio_rft")(Config.from_dict(raw), device="cpu")
    logged = []
    tr.logger.log = lambda log, step: logged.append((step, dict(log)))
    state = tr.train(max_steps=4)
    assert state.step == 4
    (step, log), = [e for e in logged if "eval/audio_latent_std" in e[1]]
    assert step == 4 and np.isfinite(log["eval/audio_latent_std"])
    # the VAE keys are ported: vae_cfg_path takes the bridge's
    # seeded encoder, vae_ckpt_path reads <path>_enc (and _dec), and
    # waveforms [b, T, 2] are encoded while latents pass as they are
    from owl_audio_exps_tpu_torch.utils.owl_vae_bridge import (
        get_audio_encoder_decoder)
    enc, dec = get_audio_encoder_decoder(device="cpu")
    torch.save(enc.module.state_dict(), tmp_path / "vae_enc")
    torch.save(dec.module.state_dict(), tmp_path / "vae_dec")
    wf = torch.randn(1, 2 * 735, 2)
    for key, value in (("vae_cfg_path", "in_repo"),
                       ("vae_ckpt_path", str(tmp_path / "vae"))):
        raw_vae = _audio_train_dict(tmp_path)
        raw_vae["train"][key] = value
        tr_vae = get_trainer_cls("audio_rft")(Config.from_dict(raw_vae),
                                              device="cpu")
        lat = tr_vae.to_latents(wf)
        assert tuple(lat.shape) == (1, 2, 64) and torch.isfinite(lat).all()
        if key == "vae_ckpt_path":
            torch.testing.assert_close(lat, enc(wf), rtol=0, atol=0)
        x = torch.randn(2, 32, 16)
        assert tr_vae.to_latents(x) is x
    # eval_media_dir: the eval decodes its first sample and writes a WAV
    raw_media = _audio_train_dict(tmp_path)
    raw_media["train"].update(save_interval=1000,
                              eval_media_dir=str(tmp_path / "media"))
    tr_media = get_trainer_cls("audio_rft")(Config.from_dict(raw_media),
                                            device="cpu")
    tr_media.train(max_steps=4)
    from scipy.io import wavfile
    rate, samples = wavfile.read(tmp_path / "media" / "audio_4.wav")
    assert rate == 44100 and samples.shape[1] == 2
    assert samples.shape[0] % 735 == 0 and samples.dtype == np.int16


def test_audio_entry_point_and_port_cuts(tmp_path, capsys):
    """configs/audio.yml through train.py: local_waveform becomes
    synthetic_audio_latent at the model's latent window, audio_caching is
    kept; the entry point runs a cut-down copy on the CPU."""
    import yaml
    from owl_audio_exps_tpu_torch.train import main, port_cuts
    cfg = Config.from_yaml("configs/audio.yml")
    cuts = port_cuts(cfg, 1)
    assert len(cuts) == 1 and cuts[0].startswith("data_id 'local_waveform'")
    assert cfg.train.data_id == "synthetic_audio_latent"
    assert dict(cfg.train.data_kwargs.items()) == dict(window_length=120,
                                                       channels=64)
    assert cfg.train.sampler_id == "audio_caching"
    with open("configs/audio.yml") as f:
        raw = yaml.safe_load(f)
    raw["model"].update(n_layers=2, n_heads=2, d_model=32, sample_size=8,
                        channels=4)
    raw["train"].update(batch_size=2, target_batch_size=2,
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        output_path=None)
    path = tmp_path / "audio.yml"
    path.write_text(yaml.safe_dump(raw))
    main(["--config_path", str(path), "--max_steps", "1", "--device", "cpu"])
    assert "synthetic_audio_latent" in capsys.readouterr().out


# ------------------------------------------------------------------- int8

def _jax_selected(tree):
    """Port module names of the kernels the JAX package quantized."""
    names = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] == "q":
            names.append(".".join(keys[:-2]).replace("blocks_", "blocks."))
    return sorted(names)


def test_int8_selects_the_jax_weights_and_matches_its_forward():
    """quantize_params_int8 picks the same matmul weights as the JAX
    package's (>= min_elems, 2-D), with the same codes and scales, and
    the int8 forward equals the JAX int8 forward; it stays close to the
    float forward (tests/test_wquant.py: cosine > 0.995)."""
    jcfg, pcfg, jcore, params, port = audio_cores(d_model=64)
    x, ts = _inputs(2, 2, 16)
    jq = jax_quantize(params["params"], min_elems=1024)
    qport = quantize_params_int8(port, min_elems=1024)
    names = quantized_names(qport)
    assert len(names) > 1 and names == _jax_selected(jq)
    want = params_from_jax(numpy_params(params), pcfg.n_heads)
    # the port's module is a copy; the original keeps its float weights
    assert port.transformer.blocks[0].mlp.fc1.weight is not None
    for name in names:
        m = qport.get_submodule(name)
        assert m.weight is None and m.weight_q.dtype == torch.int8
        assert m.weight_q.shape == want[name + ".weight"].shape
    jout, _ = jax_apply(jcore, {"params": jq}, x, ts)
    fout, _ = jax_apply(jcore, params, x, ts)
    with torch.no_grad():
        pout = qport(t(x), t(ts))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    a, b = np.asarray(fout).ravel(), pout.numpy().ravel()
    assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.995
    # at the default 65,536 elements only t_embed's 512 x 128 layer
    default = quantized_names(quantize_params_int8(port))
    assert default == _jax_selected(jax_quantize(params["params"])) == \
        ["t_embed.mlp.fc1"]


def test_int8_codes_match_jax_and_the_float_tree_is_required():
    from owl_audio_exps_tpu.nn.wquant import quantize_kernel as jax_qk
    from owl_audio_exps_tpu_torch.nn.wquant import (dequantize_kernel,
                                                    quantize_kernel)
    w = (np.random.RandomState(0).randn(128, 512) * 0.05).astype(np.float32)
    jq = jax_qk(jnp.asarray(w))
    q, s = quantize_kernel(t(w.T))
    assert q.dtype == torch.int8 and s.shape == (512, 1)
    np.testing.assert_array_equal(s.float().numpy().T,
                                  np.asarray(jq["s"], np.float32))
    assert np.abs(q.numpy().T.astype(int)
                  - np.asarray(jq["q"]).astype(int)).max() <= 1
    wd = dequantize_kernel(q, s, torch.float32).numpy().T
    amax = np.abs(w).max(axis=0, keepdims=True)
    assert (np.abs(wd - w) <= (amax / 127.0 * 0.51 + 1e-6) * 1.01).all()
    _, _, _, params, _ = audio_cores(d_model=64)
    with pytest.raises(ValueError, match="int8"):
        params_from_jax(numpy_params(
            {"params": jax_quantize(params["params"], min_elems=1024)}), 2)


def test_int8_sampler_runs_with_int8_weights_and_ring():
    _, _, _, _, port = audio_cores(d_model=64, kv_quant="int8")
    qport = quantize_params_int8(port, min_elems=1024)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 8, 8).astype(
        np.float32))
    sampler = AudioCachingSampler(n_steps=2, num_tokens=4, max_window=8,
                                  custom_schedule=[1.0, 0.5])
    out = sampler(qport, x, generator=torch.Generator().manual_seed(1))
    assert out.shape == (1, 12, 8) and torch.isfinite(out).all()
