"""The cost functions against counts made by hand at the tiny sizes."""

from portbench import costs
ENC = dict(d_model=64, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=128,
           output_dim=48, downsample_hidden_size=16, n_window=50, n_window_infer=800)
TEXT = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=96, vocab_size=151936)


def test_encoder_flops_of_one_full_chunk():
    # 16000 samples: 100 frames, one chunk: 64 x 50, 32 x 25, 16 x 13 -> 13 tokens
    d, ch, ffn, out = 64, 16, 128, 48
    conv = 2 * 9 * (ch * 64 * 50 + ch * ch * 32 * 25 + ch * ch * 16 * 13) + 2 * ch * 16 * d * 13
    layers = 2 * (2 * 13 * (4 * d * d + 2 * d * ffn) + 4 * d * 13 * 13)
    post = 2 * 13 * (d * d + d * out)
    assert costs.encoder_flops(ENC, 16000) == conv + layers + post


def test_encoder_flops_of_a_partial_chunk():
    # 130 frames: a chunk of 100 and one of 30 (15, 8, 4 wide: 4 tokens)
    d, ch = 64, 16
    part = 2 * 9 * (ch * 64 * 15 + ch * ch * 32 * 8 + ch * ch * 16 * 4) + 2 * ch * 16 * d * 4
    full = costs.encoder_flops(ENC, 16000) - (2 * 2 * 13 * (4 * d * d + 2 * d * 128)
                                              + 2 * 4 * d * 169 + 2 * 13 * (d * d + d * 48))
    layers = 2 * (2 * 17 * (4 * d * d + 2 * d * 128) + 4 * d * 17 * 17)
    post = 2 * 17 * (d * d + d * 48)
    assert costs.encoder_flops(ENC, 130 * 160) == full + part + layers + post


def test_decoder_flops_dense():
    H, L, heads, kv, hd, inter, V = 48, 2, 4, 2, 16, 96, 151936
    W = H * (heads + 2 * kv) * hd + heads * hd * H + 3 * H * inter
    # prompt of 3 rows (keys 1, 2, 3), then 2 tokens: one step at keys 4
    want = L * (2 * W * 4 + 4 * heads * hd * (1 + 2 + 3 + 4)) + 2 * 2 * V * H
    assert costs.decoder_flops(TEXT, 3, 2) == want
    # with 2 rows reused, only row 2 (keys 3) is prefilled
    want = L * (2 * W * 2 + 4 * heads * hd * (3 + 4)) + 2 * 2 * V * H
    assert costs.decoder_flops(TEXT, 3, 2, reused=2) == want

