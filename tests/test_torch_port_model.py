"""Port parity: the TinyNeRF module against apply_tinynerf on identical
weights, carried over with params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import tinynerf as jmodel
from tinynerf_tpu_torch.models.tinynerf import (
    TinyNeRF,
    TinyNeRFConfig,
    count_params,
    params_from_jax,
    params_to_jax,
)
from tinynerf_tpu_torch.ops.encoding import encoding_dim

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(seed, dtype, num_freqs=10, hidden=128):
    """One JAX-initialized parameter set in both packages."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jmodel.TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=jdt)
    params = jmodel.init_tinynerf(jax.random.PRNGKey(seed), jcfg)
    model = TinyNeRF(TinyNeRFConfig(in_dim=jcfg.in_dim, hidden=hidden, compute_dtype=tdt))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jcfg, model


# bf16: both sides round the same operands to bf16 and accumulate in
# f32, but in different orders; an f32 sum that lands near a bf16
# rounding point of the next layer's input rounds the other way.
@pytest.mark.parametrize("dtype,atol", [("f32", 1e-5), ("bf16", 2e-3)])
@pytest.mark.parametrize("hidden,num_freqs", [(128, 10), (32, 4)])
def test_apply_matches_jax(dtype, atol, hidden, num_freqs):
    params, jcfg, model = _pair(0, dtype, num_freqs, hidden)
    x = np.random.RandomState(1).uniform(-1, 1, (64, jcfg.in_dim)).astype(np.float32)
    want_rgb, want_sigma = jmodel.apply_tinynerf(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        rgb, sigma = model(torch.from_numpy(x))
    assert rgb.shape == (64, 3) and sigma.shape == (64, 1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=atol)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=atol)


def test_param_count_schema_and_roundtrip():
    model = TinyNeRF(generator=torch.Generator().manual_seed(0))
    assert count_params(model) == 66308
    assert list(model.state_dict()) == [
        *[f"layers.{i}.{p}" for i in range(4) for p in ("weight", "bias")],
        "sigma.0.weight", "sigma.0.bias", "rgb.0.weight", "rgb.0.bias",
    ]
    assert [lin.in_features for lin in model.layers] == [63, 128, 191, 128]
    tree = params_to_jax(model)
    assert tree["layers"][2]["w"].shape == (191, 128)
    back = params_from_jax(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v)


def test_init_is_seeded_and_bounded():
    a = TinyNeRF(generator=torch.Generator().manual_seed(3))
    b = TinyNeRF(generator=torch.Generator().manual_seed(3))
    c = TinyNeRF(generator=torch.Generator().manual_seed(4))
    for va, vb, vc in zip(*(m.state_dict().values() for m in (a, b, c))):
        assert torch.equal(va, vb) and not torch.equal(va, vc)
    for lin in [*a.layers, a.sigma[0], a.rgb[0]]:
        bound = 1.0 / np.sqrt(lin.in_features)
        assert float(lin.weight.detach().abs().max()) <= bound
        assert float(lin.bias.detach().abs().max()) <= bound
