"""The port's host helpers against the JAX package's: the CLIP BPE
tokenizer on a synthetic merges table (the real one ships with the
checkpoints), the ftfy stand-in, the init image, the inpainting mask and
its erosion, and the uint8 image conversions (``kandinsky2_tpu.native``,
through its C++ library where built, else its numpy fallback)."""

import gzip

import numpy as np
import pytest
from PIL import Image

from kandinsky2_tpu import native as jnative
from kandinsky2_tpu import utils as jutils
from kandinsky2_tpu.tokenizers import CLIPBPETokenizer as JaxTokenizer
from kandinsky2_tpu.tokenizers.textfix import fix_text as jfix_text
from kandinsky2_tpu_torch import host_ops, utils
from kandinsky2_tpu_torch.tokenizers import CLIPBPETokenizer
from kandinsky2_tpu_torch.tokenizers.textfix import fix_text

TEXTS = ["hello world cat", "hello cat", "", "héllo ✨ wörld", "LÃ³pez cat",
         "hello world cat hello world cat hello world", "a &amp; b  \t c"]


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    # the synthetic table of tests/test_clip_bpe.py
    lines = ["#version: 0.2", "h e", "l l", "he ll", "hell o</w>", "w o", "wo r",
             "wor l", "worl d</w>", "c a", "ca t</w>"]
    path = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n" + "\n".join(["q q"] * 5))
    return str(path)


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(merges, text):
    ours, theirs = CLIPBPETokenizer(merges), JaxTokenizer(merges)
    assert ours.encoder == theirs.encoder
    assert ours.encode(text) == theirs.encode(text)
    assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    for ctx in (4, 6, 77):
        got, want = ours.padded_tokens_and_mask([text, "cat"], ctx), \
            theirs.padded_tokens_and_mask([text, "cat"], ctx)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("text", ["LÃ³pez", "Ã©tÃ©", "âœ” ok", "CafÃƒÂ©", "não",
                                  "plain ascii", "é"])
def test_fix_text_matches_jax(text):
    assert fix_text(text) == jfix_text(text)


def _mask(seed, h, w):
    rng = np.random.RandomState(seed)
    m = np.ones((h, w), np.float32)
    m[rng.rand(h, w) < 0.15] = 0.0
    m[: h // 3, w // 2:] = 0.0
    return m


@pytest.mark.parametrize("shape", [(9, 7), (1, 12, 12, 1), (16, 16)])
def test_prepare_mask_matches_jax(shape):
    m = _mask(sum(shape), *[n for n in shape if n > 1]).reshape(shape)
    want = jutils.prepare_mask(m)
    got = utils.prepare_mask(m)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_erode_mask_matches_jax():
    m = _mask(3, 20, 13)
    np.testing.assert_array_equal(host_ops.erode_mask(m), jnative.erode_mask(m))
    # one inpainted pixel zeroes itself and six neighbours
    one = np.ones((5, 5), np.float32)
    one[2, 2] = 0
    assert int((host_ops.erode_mask(one) == 0).sum()) == 7


def test_uint8_conversions_match_jax():
    rng = np.random.RandomState(4)
    x = (1.2 * rng.randn(2, 5, 7, 3)).astype(np.float32)
    x[0, 0, :4, 0] = [-1.0, 1.0, 0.5 / 127.5 - 1, 1.5 / 127.5 - 1]  # ties, ends
    np.testing.assert_array_equal(host_ops.f32_to_u8_images(x),
                                  jnative.f32_to_u8_images(x))
    u = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    # the semantics are the numpy fallback's, u / 127.5 - 1; the C++
    # library multiplies by 1/127.5, within an ulp of it
    np.testing.assert_array_equal(host_ops.u8_to_f32_images(u),
                                  u.astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_allclose(host_ops.u8_to_f32_images(u),
                               jnative.u8_to_f32_images(u), rtol=0, atol=2e-7)
    np.testing.assert_array_equal(host_ops.f32_to_u8_images(host_ops.u8_to_f32_images(u)), u)


def test_prepare_image_matches_jax():
    rng = np.random.RandomState(5)
    imgs = [Image.fromarray(rng.randint(0, 256, (50, 70, 3), np.uint8))
            for _ in range(2)]
    np.testing.assert_array_equal(utils.prepare_image(imgs[0], 64, 48),
                                  jutils.prepare_image(imgs[0], 64, 48))
    np.testing.assert_array_equal(utils.prepare_image_batch(imgs, 32, 32, 2),
                                  jutils.prepare_image_batch(imgs, 32, 32, 2))
    with pytest.raises(ValueError):
        utils.prepare_image_batch(imgs, 32, 32, 3)
