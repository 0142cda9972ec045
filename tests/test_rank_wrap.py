"""Wrap-safe rank helpers: values >= 2^31 carried as wrapped int32."""

import jax.numpy as jnp
import numpy as np

from salt_tpu.ops.rank import ugt, umin


def test_ugt_wrapped_values():
    # 3e9 wraps negative as int32; unsigned compare must still order it
    a = jnp.asarray(np.array([3_000_000_000], np.uint32).view(np.int32))
    b = jnp.asarray(np.array([5], np.int32))
    assert bool(ugt(a, b)[0])           # 3e9 > 5
    assert not bool(ugt(b, a)[0])
    # equal wrapped values
    assert not bool(ugt(a, a)[0])


def test_umin_wrapped_bound():
    vals = np.array([3_000_000_000, 7, 4_000_000_000], np.uint32)
    a = jnp.asarray(vals.view(np.int32))
    out = np.asarray(umin(a, jnp.uint32(3_500_000_000))).view(np.uint32)
    assert list(out) == [3_000_000_000, 7, 3_500_000_000]

