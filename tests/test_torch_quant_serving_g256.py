"""PyTorch port, quantized serving at ``quant.group_size: 256``: the torch
InferenceEngineV2 held to the JAX engine on the same numpy weights, in fp32
on the CPU.  The models, configs and helpers are
tests/test_torch_quant_serving.py's; this file holds the group-256 cases
(their own hidden-256 model and JAX engines) so that pytest-xdist can run
them beside that file's.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_quant_serving import (GROUP256, _prompts, _torch_engine,
                                      _walk)
from test_torch_quant_serving import jax_engines, trees  # noqa: F401 (fixtures)

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)


class TestGroup256:
    """``quant.group_size: 256`` (the JAX engine's weight_group_size packs
    groups of 256 wherever the dim allows): the packed tree is bit-equal to
    the JAX engine's, holds groups of 256, and greedy generate is
    token-exact (the card's kernels take these groups:
    tests/test_torch_cuda_kernels.py)."""

    @pytest.mark.parametrize("name", sorted(GROUP256))
    def test_packed_and_greedy_equal_jax(self, trees, jax_engines, name):
        jeng = jax_engines("llama256", name)
        jtree = jax.tree_util.tree_map(np.asarray, jeng.params)
        eng = _torch_engine(trees, "llama256", name)
        groups = set()
        for path, want, got in _walk(jtree, eng.params):
            if isinstance(want, dict):
                codes = "v4" if "v4" in want else "v"
                for key in want:
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  want[key], err_msg=str(path))
                rows = got[codes].shape[0] * (2 if codes == "v4" else 1)
                if got["s"].shape[1:] == got[codes].shape[1:]:
                    groups.add(rows // got["s"].shape[0])
            else:
                np.testing.assert_array_equal(got.numpy(), want)
        assert 256 in groups, groups
        prompts = _prompts(n=3, vocab=512)
        want = jeng.generate(prompts, max_new_tokens=12)
        got = eng.generate(prompts, max_new_tokens=12)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
