"""The benchmark's operation and byte counts against numbers worked by hand."""

import pytest

from benchmark import work


def test_vit_b16_block_by_hand():
    # one ViT-B/16 block over one 224 px image: 197 tokens of width 768
    length, d = 197, 768
    qkv = 2 * 197 * 768 * 2304  # 697,171,968
    core = 4 * 197 * 197 * 768  # 119,221,248
    out = 2 * 197 * 768 * 768  # 232,390,656
    assert (qkv, core, out) == (697_171_968, 119_221_248, 232_390_656)
    flops, nbytes = work.attn_half(1, length, d)
    assert flops == qkv + core + out == 1_048_783_872
    # x read and written, qkv and out weights, qkv, out and LayerNorm vectors
    assert nbytes == 2 * (2 * 197 * 768 + 4 * 768 * 768 + 6 * 768) == 5_332_992
    flops, nbytes = work.mlp_half(1, length, d)
    assert flops == 2 * 2 * 197 * 768 * 3072 == 1_859_125_248
    assert nbytes == 2 * (2 * 197 * 768 + 8 * 768 * 768 + 7 * 768) == 10_053_120
    block = work.tower(1, length, d, 1)
    assert block.flops == 2_907_909_120
    # one image: both halves wait on their weights (5.3 MB in 1.59 us against
    # 1.05 GFLOP in 1.06 us; 10.1 MB in 3.00 us against 1.86 GFLOP in 1.88 us)
    assert block.bound_s == pytest.approx((5_332_992 + 10_053_120) / 3.35e12)
    # 512 images: compute-bound, the FLOPs at the bf16 peak
    assert work.tower(512, length, d, 1).bound_s == pytest.approx(512 * 2_907_909_120 / 989e12)


def test_text_block_by_hand():
    # one causal text block of CLIP ViT-B/16 over one 77-token prompt, width 512
    flops, nbytes = work.attn_half(1, 77, 512, causal=True)
    pairs = 77 * 78 // 2  # 3003 query-key pairs under the causal mask
    assert flops == 2 * 77 * 512 * 1536 + 4 * pairs * 512 + 2 * 77 * 512 * 512 == 167_630_848
    assert nbytes == 2 * (2 * 77 * 512 + 4 * 512 * 512 + 6 * 512) == 2_260_992
    flops, nbytes = work.mlp_half(1, 77, 512)
    assert flops == 322_961_408
    # memory-bound at one prompt: the weights dominate
    assert work.tower(1, 77, 512, 1, causal=True).bound_s == pytest.approx(
        2_260_992 / 3.35e12 + (2 * (2 * 77 * 512 + 8 * 512 * 512 + 7 * 512)) / 3.35e12)


def test_request_counts_add_up():
    cfg = {"vision_patch_size": 16, "vision_width": 768, "image_resolution": 224,
           "vision_layers": 12, "embed_dim": 512, "transformer_width": 512,
           "context_length": 77, "transformer_layers": 12, "n_ctx": 2, "generator_layers": 4}
    whole = work.generate_request(cfg, 32, 16, encode=True)
    parts = work.vision(cfg, 512)
    parts += work.generator(cfg, 32, 16)
    parts += work.text(cfg, 96)
    parts += work.fusion(cfg, 32, 16)
    assert whole.flops == parts.flops and whole.bound_s == parts.bound_s
    assert work.generate_request(cfg, 32, 16, encode=False).flops == whole.flops - work.vision(
        cfg, 512).flops
    # ViT-B/16 at 224 px: ~35 GFLOP an image (12 blocks + patch embedding + projection)
    assert 34e9 < work.vision(cfg, 1).flops < 36e9
    step = work.train_step(cfg, 192, 8, 4, 256, 224, 12_600_000)
    assert step.flops > work.vision(cfg, 1536).flops
