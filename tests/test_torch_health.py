"""The port's status-bit registry equals the JAX package's, value for
value, and its helpers behave the same on torch tensors."""

import numpy as np
import torch

from raft_tpu.utils import health as jh
from raft_tpu_torch.utils import health as th


def test_registry_equal_value_for_value():
    assert th.MASKS == jh.MASKS
    for name in jh.MASKS:
        assert getattr(th, name) == getattr(jh, name)
    assert th.SEVERE == jh.SEVERE
    assert th.INFORMATIONAL == jh.INFORMATIONAL
    assert th.OK == jh.OK


def test_helpers_on_tensors_match_numpy():
    cond = np.array([True, False, True])
    s_np = jh.set_bit(np.zeros(3, dtype=np.int32), jh.DRAG_CAP_HIT, cond)
    s_t = th.set_bit(torch.zeros(3, dtype=torch.int32), th.DRAG_CAP_HIT,
                     torch.as_tensor(cond).to(torch.int32))
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(s_t.numpy(), s_np)
    np.testing.assert_array_equal(th.any_bit(s_t).numpy(),
                                  jh.any_bit(s_np))


def test_describe_matches_jax():
    """The status text the statics warning prints equals the JAX
    package's for every single bit, a combination and unknown bits."""
    for s in [0, *jh.MASKS.values(), jh.SEVERE, jh.SEVERE | (1 << 9)]:
        assert th.describe(s) == jh.describe(s)
