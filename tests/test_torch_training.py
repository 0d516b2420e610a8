"""PyTorch port, the training path: each piece of
``deepspeed_tpu_torch.initialize`` → ``engine.train_batch`` held to its JAX
counterpart on the same numpy-seeded inputs, and the slice as a whole —
both engines from the same initial weights (``load_params``) over the same
batches.  fp32 on the CPU unless said; tolerances are stated per test."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu import config as jconfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops import lm_cross_entropy as j_lm_cross_entropy
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu.runtime import dataloader as jdata
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.runtime import precision as jprec
from deepspeed_tpu.runtime import zero as jzero
from deepspeed_tpu_torch import config as tconfig
from deepspeed_tpu_torch.engine import OVERFLOW_GNORM
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import lm_cross_entropy as t_lm_cross_entropy
from deepspeed_tpu_torch.runtime import dataloader as tdata
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime import precision as tprec

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)


# ------------------------------------------------------------ cross entropy

@pytest.mark.parametrize("mode", ["fused", "checkpointed", "one_shot"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_lm_cross_entropy_matches_jax(mode, with_bias):
    """Loss and the gradients of x, w (and bias) at 1e-5; 40 tokens in
    chunks of 16, so the last chunk is padded with mask-0 rows."""
    rng = np.random.default_rng(0)
    b, t, h, v = 2, 20, 12, 37
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) < 0.8).astype(np.float32)
    kw = dict(chunk_size=None if mode == "one_shot" else 16,
              fused=mode == "fused")

    def jloss(x_, w_, b_):
        return j_lm_cross_entropy(x_, w_, jnp.asarray(labels),
                                  jnp.asarray(mask),
                                  bias=b_ if with_bias else None, **kw)
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    tl = t_lm_cross_entropy(tx, tw, torch.from_numpy(labels),
                            torch.from_numpy(mask),
                            bias=tb if with_bias else None, **kw)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg[1]), atol=1e-5)
    if with_bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]),
                                   atol=1e-5)


def test_fused_cross_entropy_under_no_grad_keeps_nothing():
    x = torch.randn(2, 16, 8, requires_grad=True)
    w = torch.randn(8, 11, requires_grad=True)
    labels = torch.randint(0, 11, (2, 16))
    mask = torch.ones(2, 16)
    want = t_lm_cross_entropy(x, w, labels, mask, chunk_size=None)
    with torch.no_grad():
        got = t_lm_cross_entropy(x, w, labels, mask, chunk_size=8)
    assert not got.requires_grad and got.grad_fn is None
    torch.testing.assert_close(got, want.detach())
    # the upstream cotangent scales the stored gradients
    loss = 3.0 * t_lm_cross_entropy(x, w, labels, mask, chunk_size=8)
    gx, = torch.autograd.grad(loss, x)
    gx_ref, = torch.autograd.grad(3.0 * want, x)
    torch.testing.assert_close(gx, gx_ref, atol=1e-6, rtol=1e-5)


# --------------------------------------------------------------- schedules

SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                     warmup_num_steps=10),
    "WarmupLR_linear": dict(warmup_max_lr=1e-2, warmup_num_steps=7,
                            warmup_type="linear"),
    "WarmupDecayLR": dict(total_num_steps=40, warmup_max_lr=1e-2,
                          warmup_num_steps=10),
    "WarmupCosineLR": dict(total_num_steps=45, warmup_num_steps=5,
                           warmup_max_lr=3e-3),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                     cycle_first_step_size=10, cycle_second_step_size=15,
                     decay_step_size=5, decay_lr_rate=0.5),
    "LRRangeTest": dict(lr_range_test_min_lr=1e-3,
                        lr_range_test_step_size=7,
                        lr_range_test_step_rate=2.0),
    "LRRangeTest_stairs": dict(lr_range_test_step_size=7,
                               lr_range_test_staircase=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    kind = name.split("_")[0]
    js = jsched.build_schedule(kind, SCHEDULES[name])
    ts = tsched.build_schedule(kind, SCHEDULES[name])
    for step in range(51):
        got = ts(step)
        assert isinstance(got, float)
        assert abs(got - float(js(jnp.int32(step)))) <= 1e-7, (step, got)
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsched.build_schedule("nope", {})
    assert tsched.constant(0.5)(17) == 0.5


# -------------------------------------------------------------- loss scale

@pytest.mark.parametrize("cfg", [
    dict(enabled=True, initial_scale_power=4, loss_scale_window=3,
         hysteresis=2, min_loss_scale=2.0),
    dict(enabled=True, loss_scale=128.0),
    dict(enabled=False),
], ids=["dynamic", "static", "off"])
def test_loss_scale_state_machine_matches_jax(cfg):
    script = [True, True, False, False, True, True, True, True, False,
              False, False, False, False, True, True, True]
    jc, tc = jconfig.FP16Config(**cfg), tconfig.FP16Config(**cfg)
    js, ts = jprec.init_loss_scale(jc), tprec.init_loss_scale(tc)
    for finite in script:
        js = jprec.update_loss_scale(js, jnp.bool_(finite), jc)
        ts = tprec.update_loss_scale(ts, finite, tc)
        assert tuple(ts) == (float(js.scale), int(js.growth_counter),
                             int(js.hysteresis), int(js.skipped))


def test_grads_finite():
    good = [torch.ones(3), torch.zeros(2, 2)]
    assert bool(tprec.grads_finite(good))
    assert not bool(tprec.grads_finite(good + [torch.tensor([1.0, math.inf])]))
    assert not bool(tprec.grads_finite(good + [torch.tensor([math.nan])]))


# -------------------------------------------------------------- optimizers

OPTIMIZERS = {
    "adamw": ("adamw", dict(lr=1e-2, weight_decay=0.1, betas=(0.8, 0.95))),
    "fusedadam": ("FusedAdam", dict(lr=3e-3, weight_decay=0.01)),
    "adam_wd": ("adam", dict(lr=1e-2, weight_decay=0.1)),
    "sgd_momentum": ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    "sgd_nesterov": ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
    "sgd_plain": ("sgd", dict(lr=0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_chain_matches_optax(name):
    """Five clipped updates on the same numpy gradients against the optax
    chain the reference engine builds, at 1e-6."""
    kind, params = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    shapes = [(4, 6), (6,), (2, 3, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * (0.2 if i % 2 else 3.0)).astype(
        np.float32) for s in shapes] for i in range(5)]   # clipped and not
    tx, _ = jopt.build_optimizer(kind, dict(params))
    tx = optax.chain(optax.clip_by_global_norm(1.0), tx)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    opt, resolved = topt.build_optimizer(kind, dict(params))
    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt.init(tp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(a.copy()) for a in g]
        topt.clip_by_global_norm(tg, 1.0)
        torch._foreach_add_(tp, opt.update(tg, tp, resolved["lr"]))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_master_weights_match_reference_in_bf16():
    """bf16 parameters with fp32 masters: after five AdamW updates the
    masters agree at 1e-6 and the bf16 parameters bit for bit but for at
    most one bf16 rounding (2^-8 relative) where a master sits on a tie."""
    rng = np.random.default_rng(1)
    shapes = [(8, 8), (8,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = jzero.with_master_weights(optax.adamw(1e-2, weight_decay=0.1))
    jp = [jnp.asarray(a).astype(jnp.bfloat16) for a in p0]
    state = tx.init(jp)
    opt = topt.MasterWeights(topt.Adam(weight_decay=0.1))
    tp = [torch.from_numpy(a).to(torch.bfloat16) for a in p0]
    opt.init(tp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        torch._foreach_add_(tp, opt.update(
            [torch.from_numpy(a.copy()) for a in g], tp, 1e-2))
    for m, jm, p, jp_ in zip(opt.master, state.master, tp, jp):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6)
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(jp_.astype(jnp.float32)),
                                   rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("name", ["lamb", "FusedLamb", "lion", "adagrad",
                                  "muon", "OneBitAdam", "onebitlamb",
                                  "ZeroOneAdam"])
def test_unported_optimizers_raise(name):
    assert name.lower() in topt.supported_optimizers()
    with pytest.raises(NotImplementedError, match="A.11"):
        topt.build_optimizer(name, {"lr": 1e-3})
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("adamz", {})
    assert topt.supported_optimizers() == jopt.supported_optimizers()
    assert topt.is_onebit(name) == jopt.is_onebit(name)


# ------------------------------------------------------------------ config

TRIADS = [
    (dict(train_batch_size=32, train_micro_batch_size_per_gpu=4), 2),
    (dict(train_batch_size=32, gradient_accumulation_steps=4), 2),
    (dict(train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=2), 1),
    (dict(train_micro_batch_size_per_gpu=3), 4),
    (dict(train_batch_size=16), 4),
    (dict(), 2),
    (dict(train_batch_size=32, train_micro_batch_size_per_gpu=4,
          gradient_accumulation_steps=4), 2),
]
BAD_TRIADS = [
    (dict(train_batch_size=30, train_micro_batch_size_per_gpu=4), 2),
    (dict(train_batch_size=30, gradient_accumulation_steps=4), 2),
    (dict(train_batch_size=15), 2),
    (dict(train_batch_size=32, train_micro_batch_size_per_gpu=4,
          gradient_accumulation_steps=3), 2),
]


@pytest.mark.parametrize("cfg,world", TRIADS)
def test_batch_triad_matches_jax(cfg, world):
    jc, tc = jconfig.parse_config(dict(cfg)), tconfig.parse_config(dict(cfg))
    jc.resolve_batch_size(world)
    tc.resolve_batch_size(world)
    assert (tc.train_batch_size, tc.train_micro_batch_size_per_gpu,
            tc.gradient_accumulation_steps) == (
        jc.train_batch_size, jc.train_micro_batch_size_per_gpu,
        jc.gradient_accumulation_steps)


@pytest.mark.parametrize("cfg,world", BAD_TRIADS)
def test_batch_triad_errors_match_jax(cfg, world):
    with pytest.raises(ValueError) as je:
        jconfig.parse_config(dict(cfg)).resolve_batch_size(world)
    with pytest.raises(ValueError) as te:
        tconfig.parse_config(dict(cfg)).resolve_batch_size(world)
    assert str(te.value).replace("\n", " ").split() == \
        str(je.value).replace("\n", " ").split()


def test_parse_config_forms(tmp_path):
    import json
    d = {"train_batch_size": 8, "bf16": {"enabled": True},
         "optimizer": {"type": "AdamW", "params": {"lr": 0.01}},
         "scheduler": {"type": "WarmupLR", "params": {}},
         "zero_optimization": {"stage": 3}, "some_future_key": 1}
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(d))
    a, b = tconfig.parse_config(str(path)), tconfig.parse_config(d)
    assert tconfig.parse_config(a) is a
    for c in (a, b):
        assert c.compute_dtype == torch.bfloat16
        assert c.zero_optimization.stage == 3 and c.scheduler.type == "WarmupLR"
        assert c.extra == {"some_future_key": 1}
        c.check_implemented()
    assert tconfig.parse_config(None).compute_dtype == torch.float32
    assert tconfig.parse_config({"fp16": {"enabled": True}}).compute_dtype \
        == torch.float16
    with pytest.raises(ValueError, match="fp16 and bf16"):
        tconfig.parse_config({"fp16": {"enabled": True},
                              "bf16": {"enabled": True}})
    with pytest.raises(TypeError):
        tconfig.parse_config({"gradient_clipping": "1"})
    with pytest.raises(ValueError, match="stage"):
        tconfig.parse_config({"zero_optimization": {"stage": 4}})


UNPORTED_BLOCKS = {
    "offload_optimizer": ({"zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}}, "A.9"),
    "offload_param": ({"zero_optimization": {
        "stage": 3, "offload_param": {"device": "nvme"}}}, "A.9"),
    "zeropp": ({"zero_optimization": {"zero_quantized_gradients": True}},
               "A.8"),
    "mics": ({"zero_optimization": {"stage": 3, "mics_shard_size": 4}}, "A.8"),
    "overlap": ({"overlap": {"enabled": True}}, "A.8"),
    "moe": ({"moe": {"wire_bits": 8}}, "A.8"),
    "mesh": ({"mesh": {"tp": 2}}, "A.8"),
    "telemetry": ({"telemetry": {"enabled": True}}, "A.10"),
    "flops_profiler": ({"flops_profiler": {"enabled": True}}, "A.10"),
    "guardian": ({"guardian": {"enabled": True}}, "A.9"),
    "elasticity": ({"elasticity": {"enabled": True}}, "A.9"),
    "resilience": ({"resilience": {"compilation_cache_dir": "/x"}}, "A.9"),
    "data_efficiency": ({"data_efficiency": {"enabled": True}}, "A.11"),
    "progressive_layer_drop": ({"progressive_layer_drop": {"enabled": True}},
                               "A.11"),
    "compression_training": ({"compression_training": {
        "weight_quantization": {}}}, "A.11"),
    "gradient_compression": ({"gradient_compression": {"enabled": True}},
                             "A.11"),
    "hybrid_engine": ({"hybrid_engine": {"enabled": True}}, "A.11"),
    "wall_clock_breakdown": ({"wall_clock_breakdown": True}, "A.10"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED_BLOCKS))
def test_unported_config_blocks_raise(name):
    """A block the port lacks parses, is accepted at its default, and
    raises naming its ROADMAP item when it asks for behaviour."""
    cfg, item = UNPORTED_BLOCKS[name]
    parsed = tconfig.parse_config(cfg)
    with pytest.raises(NotImplementedError, match=item):
        parsed.check_implemented()
    with pytest.raises(NotImplementedError, match=item):
        dst.initialize(model=tgpt.GPT(tgpt.GPTConfig.tiny()), config=cfg,
                       device="cpu")
    top = next(iter(cfg))
    quiet = {} if isinstance(cfg[top], dict) else False
    tconfig.parse_config({top: quiet}).check_implemented()


def test_default_blocks_are_accepted():
    tconfig.parse_config({
        "mesh": {"dp": -1, "fsdp": "auto", "tp": 1, "pp": 1},
        "overlap": {"enabled": False, "num_chunks": 1},
        "telemetry": {"enabled": False}, "guardian": {"enabled": False},
        "zero_optimization": {"stage": 1, "zero_hpz_partition_size": 1,
                              "offload_optimizer": {"device": "none"}},
        "gradient_compression": {"enabled": False},
        "data_efficiency": {"enabled": False}}).check_implemented()


def test_model_knobs_not_ported_raise():
    C = tgpt.GPTConfig
    for kw, item in ((dict(dropout=0.1), "A.11"),
                     (dict(num_experts=4), "A.8"),
                     (dict(sequence_parallel=True), "A.8"),
                     (dict(random_ltd_layer_ids=(1,)), "A.11"),
                     (dict(act_quant_bits=8), "A.11")):
        with pytest.raises(NotImplementedError, match=item):
            tgpt.GPT(C.tiny(**kw))
    model = tgpt.GPT(C.tiny())
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A.11"):
        model({"input_ids": ids, "pld_theta": 0.5})
    with pytest.raises(NotImplementedError, match="A.11"):
        model({"input_ids": ids, "random_ltd_idx": ids})
    eng, *_ = dst.initialize(model=model, config={}, device="cpu")
    for call, item in ((eng.save_checkpoint, "A.9"),
                       (eng.load_checkpoint, "A.9"), (eng.guardian, "A.9"),
                       (eng.prefetch_loader, "A.9"),
                       (eng.hybrid_engine, "A.11"),
                       (eng.profile_comms, "A.10")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(NotImplementedError, match="A.8"):
        dst.initialize(model=model, config={}, device="cpu", mesh=object())


# -------------------------------------------------------------- dataloader

def test_dataloader_matches_jax():
    rng = np.random.default_rng(0)
    data = [{"input_ids": rng.integers(0, 9, (5,)).astype(np.int32),
             "w": np.float32(i)} for i in range(29)]
    kw = dict(micro_batch_size_per_gpu=2, gradient_accumulation_steps=3,
              dp_world_size=2)
    for drop_last in (True, False):
        jl = list(jdata.DeepSpeedDataLoader(data, drop_last=drop_last, **kw))
        tl = list(tdata.DeepSpeedDataLoader(data, drop_last=drop_last, **kw))
        assert len(jl) == len(tl) == (2 if drop_last else 3)
        for a, b in zip(jl, tl):
            assert a.keys() == b.keys()
            for k in a:
                assert b[k].shape[:2] == (3, 4)
                np.testing.assert_array_equal(a[k], b[k])
    assert len(tdata.DeepSpeedDataLoader(data, **kw)) == 2
    rep = tdata.RepeatingLoader([1, 2])
    assert [next(rep) for _ in range(5)] == [1, 2, 1, 2, 1]


# ----------------------------------------------------- the slice as a whole

T = 16
DS_BASE = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"total_num_steps": 20, "warmup_min_lr": 2e-4,
                             "warmup_max_lr": 3e-3, "warmup_num_steps": 3}},
    "gradient_clipping": 0.5, "zero_optimization": {"stage": 2},
    "steps_per_print": 0}

MODELS = {
    # GPT-2 style: learned positions, LayerNorm, tanh-GELU, tied embeddings;
    # 32 tokens a micro-batch in chunks of 24 (one padded chunk)
    "gpt2": lambda C, **kw: C.tiny(vocab_size=256, max_seq_len=32,
                                   loss_chunk=24, **kw),
    # llama style: GQA (4 query heads on 2 KV heads), rope, RMSNorm, SwiGLU,
    # untied unembed
    "llama": lambda C, **kw: C.llama(num_layers=2, hidden=64, heads=4,
                                     num_kv_heads=2, vocab_size=128,
                                     max_seq_len=32, loss_chunk=24, **kw),
}


def _batches(vocab, n=5, seed=0, explicit_labels=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (4, T)).astype(np.int32)
        b = {"input_ids": ids}
        if explicit_labels:
            b["labels"] = np.concatenate(
                [ids[:, 1:], np.full((4, 1), -100, np.int32)], axis=1)
            b["loss_mask"] = np.ones((4, T), np.float32)
        out.append(b)
    return out


def _to_np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)), tree)


def _flat(tree):
    return dict(tgpt._flatten(tree))


def _run_both(kind, ds_extra, batches, jdtype=None, tdtype=None, trio=False):
    """Both engines from the JAX engine's initial weights over ``batches``.
    Returns per-side lists of (loss, grad_norm, loss_scale, skipped, lr),
    the final parameter trees, an eval loss each, and the port's engine."""
    vocab = 256 if kind == "gpt2" else 128
    jkw = {} if jdtype is None else {"dtype": jdtype}
    tkw = {} if tdtype is None else {"dtype": tdtype}
    jcfg = MODELS[kind](jgpt.GPTConfig, **jkw)
    tcfg = MODELS[kind](tgpt.GPTConfig, **tkw)
    ds = {**DS_BASE, **ds_extra}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt.GPTChunkedLoss(jcfg), config=dict(ds),
        example_batch=jax.tree_util.tree_map(lambda x: x[:2], batches[0]),
        mesh=single_device_mesh())
    init = _to_np(jeng.state.params)
    model = tgpt.GPTChunkedLoss(tcfg).load_params(init)
    teng, topt_, tloader, tsched_ = dst.initialize(
        model=model, config=dict(ds), example_batch=batches[0], device="cpu")
    assert tloader is None and tsched_ is teng.lr_schedule \
        and topt_ is teng.optimizer
    rows = {"jax": [], "torch": []}
    for b in batches:
        jm = jeng.train_batch(b)
        rows["jax"].append((float(jm.loss), float(jm.grad_norm),
                            float(jm.loss_scale), int(jm.skipped_steps),
                            jeng.get_lr()[0]))
        if trio:
            for i in range(teng.gas):
                mb = {k: v[2 * i:2 * i + 2] for k, v in b.items()}
                teng.backward(teng.forward(mb))
                assert teng.is_gradient_accumulation_boundary() == (
                    i == teng.gas - 1)
                if i < teng.gas - 1:
                    assert teng.step() is None      # not at the boundary
            tm = teng.step()
        else:
            tm = teng.train_batch(b)
        assert teng.get_global_grad_norm() == tm.grad_norm
        rows["torch"].append((tm.loss, tm.grad_norm, tm.loss_scale,
                              tm.skipped_steps, teng.get_lr()[0]))
    evals = (float(jeng.eval_batch(batches[0])),
             float(teng.eval_batch(batches[0])))
    return rows, _to_np(jeng.state.params), tgpt.params_to_numpy(model), \
        evals, teng


def _compare(rows, tol):
    for step, (j, t) in enumerate(zip(rows["jax"], rows["torch"])):
        assert abs(j[0] - t[0]) <= tol, ("loss", step, j, t)
        assert abs(j[1] - t[1]) <= tol, ("grad_norm", step, j, t)
        assert j[2] == t[2] and j[3] == t[3], ("scale/skipped", step, j, t)
        assert abs(j[4] - t[4]) <= 1e-8, ("lr", step, j, t)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_train_batch_matches_jax_fp32(kind):
    """5 steps in fp32: loss and grad norm at 1e-5 each step, final
    parameters at 1e-5, then eval_batch."""
    batches = _batches(256 if kind == "gpt2" else 128)
    rows, jp, tp, evals, teng = _run_both(kind, {}, batches)
    _compare(rows, 1e-5)
    assert rows["torch"][-1][0] < rows["torch"][0][0] + 1.0
    jp, tp = _flat(jp["params"]), _flat(tp)
    assert jp.keys() == tp.keys()
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    assert abs(evals[0] - evals[1]) <= 1e-5
    assert teng.global_steps == 5 and teng.step_clock == 5 \
        and teng.skipped_steps == 0
    assert (teng.train_batch_size, teng.train_micro_batch_size_per_gpu) \
        == (4, 2)


def test_trio_equals_train_batch():
    """forward/backward/step over the micro-batches gives what train_batch
    gives (held to the JAX engine's train_batch at 1e-5)."""
    rows, jp, tp, _, teng = _run_both("gpt2", {}, _batches(256, n=3),
                                      trio=True)
    _compare(rows, 1e-5)
    jp, tp = _flat(jp["params"]), _flat(tp)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=1e-5, rtol=0)
    with pytest.raises(RuntimeError, match="forward"):
        teng.step()


def test_train_batch_matches_jax_bf16():
    """bf16 parameters with fp32 masters.  XLA on the CPU and PyTorch
    round bf16 products at different places (XLA widens some bf16
    arithmetic to fp32), so the two trajectories agree only to bf16
    resolution: loss and grad norm within 5e-2, parameters within 2e-2
    (a few bf16 roundings at magnitude ~1)."""
    batches = _batches(256)
    rows, jp, tp, evals, _ = _run_both(
        "gpt2", {"bf16": {"enabled": True}}, batches,
        jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    _compare(rows, 5e-2)
    jp, tp = _flat(jp["params"]), _flat(tp)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=2e-2, rtol=0,
                                   err_msg=name)
    assert abs(evals[0] - evals[1]) <= 5e-2


def test_fp16_overflow_skips_on_both_sides():
    """fp16 with dynamic loss scaling; the third batch carries a NaN in its
    loss mask.  Both engines skip that step (grad_norm reads the overflow
    sentinel), halve the scale, count one skipped step and leave the
    schedule clock where it was; clean steps agree to fp16 resolution."""
    batches = _batches(256, explicit_labels=True)
    batches[2]["loss_mask"][1, 3] = np.nan
    fp16 = {"enabled": True, "initial_scale_power": 6, "hysteresis": 1,
            "loss_scale_window": 2}
    rows, _, _, _, teng = _run_both("gpt2", {"fp16": fp16}, batches,
                                    jdtype=jnp.float16, tdtype=torch.float16)
    scales = [r[2] for r in rows["torch"]]
    assert scales == [64.0, 128.0, 64.0, 64.0, 128.0]
    for j, t in zip(rows["jax"], rows["torch"]):
        assert j[2:4] == t[2:4]
        assert abs(j[4] - t[4]) <= 1e-8
    for i in (0, 1, 3, 4):
        j, t = rows["jax"][i], rows["torch"][i]
        assert abs(j[0] - t[0]) <= 2e-2 and abs(j[1] - t[1]) <= 2e-2
    j, t = rows["jax"][2], rows["torch"][2]
    assert math.isnan(j[0]) and math.isnan(t[0])
    assert j[1] == t[1] == OVERFLOW_GNORM
    assert j[3] == t[3] == 1 and teng.skipped_steps == 1
    # the schedule clock did not move on the skipped step
    assert rows["torch"][2][4] == rows["torch"][1][4]
    assert teng.global_steps == 5 and teng.step_clock == 4


def test_form_batch_shapes_and_error_text():
    model = tgpt.GPT(tgpt.GPTConfig.tiny())
    eng, *_ = dst.initialize(model=model, config={
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 3}, device="cpu")
    flat = {"input_ids": np.zeros((6, 8), np.int32)}
    shaped = {"input_ids": np.zeros((3, 2, 8), np.int32)}
    for b in (flat, shaped):
        assert eng._form_batch(b)["input_ids"].shape == (3, 2, 8)
    with pytest.raises(ValueError) as e:
        eng.train_batch({"input_ids": np.zeros((5, 8), np.int32)})
    assert ("train_batch leading dims (5, 8) match neither [gas=3, "
            "micro_local=2, ...] nor the flat process-local batch [6, ...]"
            ) in str(e.value)
