"""``flops.py`` against a count by hand of both configurations."""

from portbench import flops, spec


def hand(D, inner, F, L, N, fd, T, V, layers=12):
    S, S2 = L + N, L + N + 2
    enc = 2 * N * fd * D + 2 * N * 5 * D + layers * (
        4 * 2 * S * D * inner + 2 * 2 * S * S * inner + 2 * 2 * S * D * F)
    ckv = layers * 2 * 2 * S2 * D * inner
    dec = layers * (4 * 2 * T * D * inner + 2 * 2 * T * D * inner
                    + 2 * 2 * T * T * inner + 2 * 2 * T * S2 * inner
                    + 2 * 2 * T * D * F)
    head = 2 * T * D * V
    return enc, ckv, dec, head


def test_vqa_train_qa_by_hand():
    m = spec.load("vqa_cl_train").config
    enc, ckv, dec, head = hand(768, 768, 3072, 20, 36, 2048, 10, 32200)
    assert flops.encoder(m) == enc
    assert flops.cross_kv(m) == ckv
    assert flops.decoder_train(m) == dec
    assert flops.train_qa(m) == 3 * (enc + ckv + dec + head)
    # ~41.4 GFLOP per QA: forward 13.8 (encoder 9.5-9.8, decoder 2.0,
    # cross k/v 1.6, head 0.5)
    assert 41e9 < flops.train_qa(m) < 42.5e9
    assert abs(head - 0.495e9) < 0.01e9


def test_nextqa_train_qa_by_hand():
    m = spec.load("nextqa_cl_train").config
    enc, ckv, dec, head = hand(768, 768, 3072, 23, 16, 2048, 6, 32200)
    assert flops.train_qa(m) == 3 * (enc + ckv + dec + head)
    ratio = flops.train_qa(m) / flops.train_qa(
        spec.load("vqa_cl_train").config)
    assert 0.6 < ratio < 0.72

