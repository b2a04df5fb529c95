"""The port's XLM-RoBERTa text tower (``more4d_tpu_torch/models/
xlm_roberta.py``) against the JAX package's on the CPU: 2 layers, dim 64,
4 heads, padded ids. The port's ``state_dict()`` goes through the JAX
package's ``convert_xlm_roberta_state_dict`` (its keys are the reference
torch module's), and the features, and ``XLMRobertaWithHead``'s pooled
head output, agree with the JAX ``apply`` within 1e-5 (fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.models.xlm_roberta import XLMRoberta as JaxXLMRoberta
from more4d_tpu.models.xlm_roberta import \
    XLMRobertaWithHead as JaxXLMRobertaWithHead
from more4d_tpu.models.xlm_roberta import convert_xlm_roberta_state_dict
from more4d_tpu_torch.models.xlm_roberta import (XLMRoberta,
                                                 XLMRobertaWithHead)

KW = dict(vocab_size=96, max_seq_len=40, type_size=1, pad_id=1, dim=64,
          num_heads=4, num_layers=2)


def _ids():
    """Two rows of 13 ids, the first padded from position 7, the second
    not at all; no id is the pad id where it is not padding."""
    rs = np.random.RandomState(0)
    ids = rs.randint(2, KW["vocab_size"], (2, 13))
    ids[0, 7:] = KW["pad_id"]
    return ids


def _seeded(module):
    """Every parameter drawn N(0, 0.05) from a seed, the norms' scales
    about 1, so the blocks and the padding mask all move the output."""
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            if "norm" in name and name.endswith("weight"):
                p.add_(1.0)
    return module.eval()


@pytest.mark.parametrize("post_norm", [True, False])
def test_features_match_jax(post_norm):
    ids = _ids()
    model = _seeded(XLMRoberta(post_norm=post_norm, **KW))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    params = convert_xlm_roberta_state_dict(model.state_dict(),
                                            num_layers=KW["num_layers"])
    want = np.asarray(JaxXLMRoberta(post_norm=post_norm, **KW).apply(
        params, jnp.asarray(ids)))
    assert got.shape == (2, 13, KW["dim"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the padding changes what the unpadded tokens see
    full = ids.copy()
    full[0, 7:] = 5
    with torch.no_grad():
        moved = model(torch.from_numpy(full)).numpy()
    assert np.abs(moved[0, :7] - got[0, :7]).max() > 1e-3


def test_head_matches_jax():
    ids = _ids()
    model = _seeded(XLMRobertaWithHead(out_dim=48, **KW))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    sd = model.state_dict()
    roberta = convert_xlm_roberta_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("head.")},
        num_layers=KW["num_layers"])["params"]
    params = {"params": {
        "roberta": roberta,
        "head_fc1": {"kernel": sd["head.0.weight"].numpy().T},
        "head_fc2": {"kernel": sd["head.2.weight"].numpy().T}}}
    want = np.asarray(JaxXLMRobertaWithHead(
        out_dim=48, roberta_kwargs=KW).apply(params, jnp.asarray(ids)))
    assert got.shape == (2, 48)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
