"""Synthetic VQACL-shaped data (counterpart of ``vqacl_tpu/data/synthetic.py``).

Deterministic examples in exactly the collator's input format, at the
real geometry, with a learnable structure: the answer token is a
function of (category, question-type), and the features and text carry
that signal. The same seed gives the same examples as the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from vqacl_tpu_torch.data.collate import collate


class SyntheticVQA:
    """A pool of synthetic (question, image-features, answer) triples."""

    def __init__(self, n: int, seed: int = 0, feat_dim: int = 2048,
                 n_boxes: int = 36, text_len: int = 20,
                 n_ques_types: int = 10, n_categories: int = 80,
                 vocab_size: int = 32200, answer_vocab: int = 64):
        rng = np.random.default_rng(seed)
        self.n = n
        self.feat_dim = feat_dim
        self.n_boxes = n_boxes
        # token ranges scale with the vocab so tiny test configs stay
        # valid; with the real 32200 vocab answers sit at 3000+, clear of
        # the <extra_id>/<vis_extra_id> blocks at the top
        ans_base = 3000 if vocab_size >= 3000 + answer_vocab \
            else vocab_size - answer_vocab
        if ans_base <= 3:
            raise ValueError("vocab too small for answer_vocab")
        q_hi = max(4, min(2000, ans_base))
        self._centroids = rng.normal(size=(n_categories, feat_dim)).astype(np.float32)
        self._q_tokens = rng.integers(3, q_hi, size=(n_ques_types, text_len - 2))
        self.examples: List[Dict] = []
        for i in range(n):
            q = int(rng.integers(0, n_ques_types))
            c = int(rng.integers(0, n_categories))
            ans_tok = ans_base + c % answer_vocab
            feats = (self._centroids[c][None]
                     + 0.3 * rng.normal(size=(n_boxes, feat_dim))).astype(np.float32)
            x1y1 = rng.uniform(0, 0.5, size=(n_boxes, 2))
            wh = rng.uniform(0.1, 0.5, size=(n_boxes, 2))
            boxes = np.concatenate([x1y1, np.clip(x1y1 + wh, 0, 1)],
                                   axis=1).astype(np.float32)
            tlen = int(rng.integers(max(2, text_len // 2), text_len))
            input_ids = [self._q_tokens[q][j % (text_len - 2)]
                         for j in range(tlen)] + [1]
            self.examples.append({
                "input_ids": [int(t) for t in input_ids],
                "vis_feats": feats,
                "boxes": boxes,
                "target_ids": [int(ans_tok), 1],   # answer token + EOS
                "score": 1.0,
                "ques_label": q,
                "cate_label": c,
                "question_id": i,
                "sent": f"synthetic question {q}",
                "answers": [str(ans_tok)],
            })

    def batches(self, batch_size: int, epochs: int = 1, seed: int = 0,
                drop_last: bool = True):
        """Collated batches over ``epochs`` seeded permutations of the
        pool; the same order as the JAX package's for the same seed."""
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(self.n)
            for s in range(0, self.n - (batch_size - 1 if drop_last else 0),
                           batch_size):
                idx = order[s:s + batch_size]
                if drop_last and len(idx) < batch_size:
                    break
                yield collate([self.examples[i] for i in idx],
                              feat_dim=self.feat_dim, n_boxes=self.n_boxes)


def synthetic_batch(batch_size: int = 8, seed: int = 0, **kw) -> Dict:
    """One collated batch."""
    pool = SyntheticVQA(batch_size, seed=seed, **kw)
    return collate(pool.examples, feat_dim=pool.feat_dim,
                   n_boxes=pool.n_boxes)
