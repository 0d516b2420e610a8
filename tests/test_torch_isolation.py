"""The PyTorch port stands alone: no file of deepspeed_tpu_torch/ and not
chip_smoke.py imports JAX, flax, pydantic or the deepspeed_tpu package (the
machines with the card have none of them), and importing the port leaves
JAX unloaded."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pydantic", "deepspeed_tpu"}


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "deepspeed_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]    # build products
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, importlib, deepspeed_tpu_torch, "
            "deepspeed_tpu_torch.ops, "
            "deepspeed_tpu_torch.inference.v2.engine_v2, "
            "deepspeed_tpu_torch.engine, deepspeed_tpu_torch.models, "
            "deepspeed_tpu_torch.runtime.lr_schedules, "
            "deepspeed_tpu_torch.runtime.precision, "
            "deepspeed_tpu_torch.runtime.optimizers, "
            "deepspeed_tpu_torch.runtime.dataloader; "
            "importlib.import_module('deepspeed_tpu_torch.ops."
            "flash_attention'); "
            "importlib.import_module('deepspeed_tpu_torch.ops."
            "cross_entropy'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pydantic', 'deepspeed_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_initialize_without_device_needs_cuda():
    """Entry points run on the card by default: on a box without CUDA,
    ``initialize(...)`` with no ``device`` raises instead of quietly
    training on the CPU."""
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPT, GPTConfig
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.initialize(model=GPT(GPTConfig.tiny()), config={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.DeepSpeedEngine(GPT(GPTConfig.tiny()), ds.parse_config({}))


def test_trained_model_serves_from_the_same_tree():
    """One parameter tree for both halves: a model trained two steps by the
    port's engine serves through the port's InferenceEngineV2 from
    ``params_to_numpy(model)``, and the served logits are the training
    model's own next-token logits."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import (GPT, GPTConfig, params_from_numpy,
                                            params_to_numpy)
    cfg = GPTConfig.llama(num_layers=2, hidden=64, heads=4, num_kv_heads=2,
                          vocab_size=128, max_seq_len=64)
    model = GPT(cfg)
    eng, *_ = ds.initialize(model=model, config={
        "train_batch_size": 4, "steps_per_print": 0,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}},
        device="cpu")
    rng = np.random.default_rng(0)
    before = params_to_numpy(model)["backbone"]["wte"].copy()
    for _ in range(2):
        eng.train_batch({"input_ids": rng.integers(0, 128, (4, 16))
                         .astype(np.int32)})
    tree = params_to_numpy(model)
    assert np.abs(tree["backbone"]["wte"] - before).max() > 0
    serve = ds.InferenceEngineV2(cfg, config={
        "dtype": "fp32", "state_manager": {
            "max_tracked_sequences": 2, "kv_block_size": 8,
            "num_kv_blocks": 16}},
        params=params_from_numpy(tree, cfg, "cpu", torch.float32),
        device="cpu")
    prompt = rng.integers(0, 128, (12,)).astype(np.int32)
    logits = serve.put([7], [prompt])
    with torch.no_grad():
        x, _ = model.backbone(torch.from_numpy(prompt)[None].long())
        want = (x[0, -1] @ model.lm_head).numpy()
    np.testing.assert_allclose(logits[0], want, atol=1e-4, rtol=1e-4)
    out = serve.generate([prompt], max_new_tokens=4)
    assert len(out[0]) == 4
