"""CLIP's ViT vision tower on the port (``models/clip_vit.py``) against a
random ``transformers`` ``CLIPVisionModelWithProjection`` and the JAX
package's tower. JAX and transformers are imported inside the tests.

Sizes: 32 px images, patches of 8, width 32, 2 layers of 2 heads, a
projection of 16. In float32 the HF conversion gives JAX's tree exactly,
the port's tower agrees with HF's image embeddings and JAX's tower within
1e-5; the config from HF's ``config.json`` dict equals JAX's from the
config object; preprocessing is equal; the per-clip frame features agree
within 1e-5 with zeros for an empty clip.
"""

import json
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow for 10+ s

HF_KW = dict(image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64, projection_dim=16,
             hidden_act="quick_gelu")


def _hf_model():
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(0)
    hf_cfg = CLIPVisionConfig(**HF_KW)
    return hf_cfg, CLIPVisionModelWithProjection(hf_cfg).eval()


def test_quick_gelu_matches_jax():
    import jax.numpy as jnp

    from spokennlp_tpu.models.clip_vit import quick_gelu as jq
    from spokennlp_tpu_torch.models.clip_vit import quick_gelu as tq

    x = np.linspace(-6, 6, 61).astype(np.float32)
    np.testing.assert_allclose(tq(torch.from_numpy(x)).numpy(), np.asarray(jq(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_tower_matches_hf_and_jax(tmp_path):
    """HF's state dict -> JAX's tree (equal to JAX's conversion) -> the
    port's state dict (strict; the patch kernel in Conv2d's layout) -> image
    embeddings against HF's and JAX's tower; the config read from the
    saved config.json equals JAX's; params_from_state_dict gives the tree
    back in Flax's layout."""
    import jax

    from spokennlp_tpu.models import clip_vit as jc
    from spokennlp_tpu_torch.models import clip_vit as tc
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    hf_cfg, hf = _hf_model()
    hf.save_pretrained(tmp_path)
    cfg = tc.clip_vit_config_from_dict(json.load(open(tmp_path / "config.json")))
    jcfg = jc.hf_clip_vision_config_to_vit_config(hf_cfg)
    assert cfg.__dict__ == jcfg.__dict__
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    tree = tc.hf_clip_vision_to_params(sd, cfg)
    want_tree = jc.hf_clip_vision_to_params(sd, jcfg)
    assert jax.tree.structure(tree) == jax.tree.structure(want_tree)
    jax.tree.map(np.testing.assert_array_equal, tree, want_tree)

    tower = tc.CLIPVisionTower(cfg)
    tower.load_state_dict(jax_params_to_state_dict(tree), strict=True)
    assert tuple(tower.patch_embed.kernel.shape) == (32, 3, 8, 8)
    back = params_from_state_dict(tower.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b, np.float32)), back,
                 tree)
    pixels = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(np.float32)
    got = tower.eval()(torch.from_numpy(pixels)).detach().numpy()
    with torch.no_grad():
        hf_out = hf(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).image_embeds
    np.testing.assert_allclose(got, hf_out.numpy(), atol=1e-5, rtol=1e-5)
    jmodel = jc.CLIPVisionTower(jcfg)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(tree, pixels)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_preprocess_and_frame_features_match_jax():
    """preprocess_images equal to JAX's (uint8 and float frames, portrait
    and landscape); encode_clip_frames' per-clip maxima within 1e-5 of
    JAX's, with a short last batch and an empty clip (zeros)."""
    import jax

    from spokennlp_tpu.models import clip_vit as jc
    from spokennlp_tpu_torch.models import clip_vit as tc
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict

    rng = np.random.default_rng(2)
    for shape in ((3, 60, 80, 3), (2, 50, 20, 3)):
        imgs = rng.integers(0, 256, size=shape).astype(np.uint8)
        np.testing.assert_array_equal(tc.preprocess_images(imgs, 32),
                                      jc.preprocess_images(imgs, 32))
        floats = imgs.astype(np.float32) / 255.0
        np.testing.assert_array_equal(tc.preprocess_images(floats, 16),
                                      jc.preprocess_images(floats, 16))
    kw = dict(image_size=16, patch_size=8, hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, projection_dim=8)
    tower = tc.CLIPVisionTower(tc.CLIPViTConfig(**kw), generator=torch.Generator().manual_seed(0))
    frames = rng.integers(0, 256, size=(7, 20, 24, 3)).astype(np.uint8)
    counts = [2, 0, 3, 2]
    got = tc.encode_clip_frames(tower, frames, counts, batch_size=4)
    want = jc.encode_clip_frames(jc.CLIPVisionTower(jc.CLIPViTConfig(**kw)),
                                 params_from_state_dict(tower.state_dict()), frames, counts,
                                 batch_size=4)
    assert got.shape == (4, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


@pytest.mark.gpu
def test_frame_features_on_the_card():
    """encode_clip_frames on the card against the CPU (float32, TF32 off)
    within 1e-5 of the largest feature."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spokennlp_tpu_torch.models import clip_vit as tc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tc.CLIPViTConfig(image_size=64, patch_size=16, hidden_size=64, num_layers=2,
                           num_heads=4, intermediate_size=128, projection_dim=32)
    tower = tc.CLIPVisionTower(cfg, generator=torch.Generator().manual_seed(0))
    frames = np.random.default_rng(3).integers(0, 256, size=(21, 80, 96, 3)).astype(np.uint8)
    counts = [5, 0, 9, 7]
    want = tc.encode_clip_frames(tower, frames, counts, batch_size=8)
    got = tc.encode_clip_frames(tower.cuda(), frames, counts, batch_size=8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
