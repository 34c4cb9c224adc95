"""The port's HuBERT featurizer against the JAX package (and ``transformers``
itself) on a tiny ``transformers.HubertConfig``, as ``test_e2e.py:108-125``
builds one.  float32; rtol=2e-4, atol=2e-5 (summation order only) against
JAX, 1e-3 / 1e-4 against ``transformers`` (its attention and GELU kernels
round differently)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import TINY_HUBERT
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    from transformers import HubertConfig, HubertModel

    from gsv_tts_tpu_torch.utils.safetensors import save_file

    torch.manual_seed(2)
    href = HubertModel(HubertConfig(**TINY_HUBERT)).eval()
    d = tmp_path_factory.mktemp("hubert")
    (d / "config.json").write_text(href.config.to_json_string())
    sd = {k: v.detach().clone() for k, v in href.state_dict().items()}
    save_file(sd, d / "model.safetensors")
    return href, d, sd


def test_hubert_forward_matches_jax_and_transformers(hub):
    from gsv_tts_tpu.models import hubert as jh
    from gsv_tts_tpu_torch.convert import hubert_from_jax
    from gsv_tts_tpu_torch.models import hubert as ph

    href, d, sd = hub
    wav = (np.random.RandomState(0).randn(1, 9600) * 0.3).astype(np.float32)
    jcfg = jh.HubertConfig.from_json(str(d / "config.json"))
    jp = jh.params_from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    pcfg = ph.HubertConfig.from_json(d / "config.json")
    pp = hubert_from_jax(jax.tree.map(np.asarray, jp))  # both compute with JAX's weights
    j = np.asarray(jh.hubert_forward(jp, jcfg, jnp.asarray(wav)))
    p = ph.hubert_forward(pp, pcfg, torch.tensor(wav)).numpy()
    assert p.shape == j.shape == (1, 29, 768)
    np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        t = href(torch.tensor(wav)).last_hidden_state.numpy()
    np.testing.assert_allclose(p, t, rtol=1e-3, atol=1e-4)


def test_cnhubert_loads_the_directory(hub):
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models.hubert import CNHubert

    href, d, _ = hub
    wav = (np.random.RandomState(1).randn(6400) * 0.3).astype(np.float32)
    out = CNHubert(str(d), Config(device="cpu"))(wav)
    with torch.no_grad():
        t = href(torch.tensor(wav[None])).last_hidden_state
    torch.testing.assert_close(out, t, rtol=1e-3, atol=1e-4)
    with pytest.raises(FileNotFoundError, match="config.json"):
        CNHubert(str(d / "missing"), Config(device="cpu"))
