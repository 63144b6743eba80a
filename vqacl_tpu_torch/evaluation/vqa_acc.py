"""Official VQA v2 accuracy with the GT-Vision-Lab normalization rules
(the port's copy of ``vqacl_tpu/evaluation/vqa_acc.py``).

The reference's ``VQAEvaluator`` (``VL-T5/src/vqa_data_memory.py:983-1200``),
which itself follows https://github.com/GT-Vision-Lab/VQA vqaEval.py:
contraction restoration, manual digit map, article dropping, punctuation
stripping with the comma-in-numbers rule, and the min(1, matches/3)
consensus scoring over 10 human answers.

Pure host-side string code (runs between device steps); the CPU tests
hold it to the JAX package's scores.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = ["a", "an", "the"]

PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    words = []
    for w in text.lower().split():
        w = MANUAL_MAP.get(w, w)
        if w not in ARTICLES:
            words.append(w)
    return " ".join(CONTRACTIONS.get(w, w) for w in words)


def normalize_answer(ans: str) -> str:
    """Full normalization chain (``normalize_answer``,
    vqa_data_memory.py:1148-1154): whitespace → punctuation → digits/
    articles → drop residual commas."""
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    ans = process_punctuation(ans)
    ans = process_digit_article(ans)
    return ans.replace(",", "")


class VQAEvaluator:
    """Soft-score + official consensus accuracy.

    ``id2datum``: quesid → {'label': {ans: score}, ...} (soft eval);
    ``id2datum_gt``: quesid → {'answers': [{'answer': str} × 10],
    'question_type': str, 'answer_type': str} (official eval).
    """

    def __init__(self, id2datum: Optional[Mapping[Any, Dict]] = None,
                 id2datum_gt: Optional[Mapping[Any, Dict]] = None):
        self.id2datum = id2datum or {}
        self.id2datum_gt = id2datum_gt or {}

    # -- soft score over the label dict (vqa_data_memory.py:1039-1046) --
    def evaluate(self, quesid2ans: Mapping[Any, str]) -> float:
        score = 0.0
        for qid, ans in quesid2ans.items():
            label = self.id2datum[qid]["label"]
            score += label.get(ans, 0.0)
        return score / max(len(quesid2ans), 1)

    # -- official VQA accuracy (vqa_data_memory.py:1069-1145) --
    def evaluate_raw(self, quesid2ans: Mapping[Any, str],
                     is_topk_optimal: Optional[bool] = None) -> Dict[str, Any]:
        acc_qa: List[float] = []
        acc_ques_type: Dict[str, List[float]] = {}
        acc_ans_type: Dict[str, List[float]] = {}

        for qid, res in quesid2ans.items():
            qid = int(qid)
            datum = self.id2datum.get(qid, {})
            if is_topk_optimal is not None and \
                    datum.get("is_topk_optimal") is not None and \
                    datum["is_topk_optimal"] != is_topk_optimal:
                continue
            gt = self.id2datum_gt[qid]
            res = res.replace("\n", " ").replace("\t", " ").strip()
            res = process_punctuation(res)
            res = process_digit_article(res)

            answers = [a["answer"] for a in gt["answers"]]
            if len(set(answers)) > 1:
                answers = [process_punctuation(a) for a in answers]
            accs = []
            for i in range(len(answers)):
                others = answers[:i] + answers[i + 1:]
                matching = [o for o in others if o == res]
                accs.append(min(1.0, len(matching) / 3.0))
            avg = sum(accs) / len(accs)
            acc_qa.append(avg)
            acc_ques_type.setdefault(gt["question_type"], []).append(avg)
            acc_ans_type.setdefault(gt["answer_type"], []).append(avg)

        if not acc_qa:
            return {"overall": 0, "perQuestionType": {}, "perAnswerType": {}}
        return {
            "overall": round(100 * sum(acc_qa) / len(acc_qa), 2),
            "perQuestionType": {k: round(100 * sum(v) / len(v), 2)
                                for k, v in acc_ques_type.items()},
            "perAnswerType": {k: round(100 * sum(v) / len(v), 2)
                              for k, v in acc_ans_type.items()},
        }

    @staticmethod
    def dump_result(quesid2ans: Mapping[Any, str], path: str) -> None:
        import json
        with open(path, "w") as f:
            json.dump([{"question_id": q, "answer": a}
                       for q, a in quesid2ans.items()],
                      f, indent=4, sort_keys=True)
