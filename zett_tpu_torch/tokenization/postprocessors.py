"""Post-processors: add special tokens and type ids around encoded
sequences, JSON-compatible with HF tokenizers (counterpart of
``zett_tpu/tokenization/postprocessors.py``): ``TemplateProcessing``,
``RobertaProcessing``, ``BertProcessing``, ``ByteLevel`` (offset trimming)
and ``Sequence``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


class PostProcessor:
    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        raise NotImplementedError

    def process(
        self,
        ids: List[int], tokens: List[str], offsets: List[Tuple[int, int]],
        pair: Optional[tuple] = None, add_special_tokens: bool = True,
    ):
        """Returns (ids, tokens, offsets, type_ids, special_mask)."""
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(data: Optional[dict]) -> Optional["PostProcessor"]:
        if data is None:
            return None
        t = data["type"]
        if t == "TemplateProcessing":
            return TemplateProcessing(data["single"], data["pair"], data["special_tokens"])
        if t == "RobertaProcessing":
            return RobertaProcessing(
                sep=tuple(data["sep"]), cls=tuple(data["cls"]),
                trim_offsets=data.get("trim_offsets", True),
                add_prefix_space=data.get("add_prefix_space", True),
            )
        if t == "BertProcessing":
            return BertProcessing(sep=tuple(data["sep"]), cls=tuple(data["cls"]))
        if t == "ByteLevel":
            return ByteLevelPost(
                trim_offsets=data.get("trim_offsets", True),
                add_prefix_space=data.get("add_prefix_space", True),
            )
        if t == "Sequence":
            return SequencePost([PostProcessor.from_json(p) for p in data["processors"]])
        raise ValueError(f"Unsupported post_processor type: {t}")


class TemplateProcessing(PostProcessor):
    """The general template: e.g. single="[CLS] $A [SEP]".

    JSON form stores pieces as [{"SpecialToken": {"id": .., "type_id": ..}} |
    {"Sequence": {"id": "A"|"B", "type_id": ..}}] and a special_tokens table
    mapping token -> ids/tokens.
    """

    def __init__(self, single, pair, special_tokens):
        self.single = single
        self.pair = pair
        # special_tokens: {"<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]}, ...}
        if isinstance(special_tokens, list):
            special_tokens = {st["id"]: st for st in special_tokens}
        self.special_tokens = special_tokens

    def _count(self, template) -> int:
        return sum(1 for piece in template if "SpecialToken" in piece)

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return self._count(self.pair if is_pair else self.single)

    def process(self, ids, tokens, offsets, pair=None, add_special_tokens=True):
        template = self.pair if pair is not None else self.single
        out_ids: List[int] = []
        out_tokens: List[str] = []
        out_offsets: List[Tuple[int, int]] = []
        out_type_ids: List[int] = []
        special_mask: List[int] = []
        for piece in template:
            if "Sequence" in piece:
                seq = piece["Sequence"]
                src = (ids, tokens, offsets) if seq["id"] == "A" else pair
                if src is None:
                    continue
                s_ids, s_tokens, s_offsets = src
                out_ids.extend(s_ids)
                out_tokens.extend(s_tokens)
                out_offsets.extend(s_offsets)
                out_type_ids.extend([seq["type_id"]] * len(s_ids))
                special_mask.extend([0] * len(s_ids))
            else:
                if not add_special_tokens:
                    continue
                st = piece["SpecialToken"]
                info = self.special_tokens[st["id"]]
                out_ids.extend(info["ids"])
                out_tokens.extend(info["tokens"])
                out_offsets.extend([(0, 0)] * len(info["ids"]))
                out_type_ids.extend([st["type_id"]] * len(info["ids"]))
                special_mask.extend([1] * len(info["ids"]))
        return out_ids, out_tokens, out_offsets, out_type_ids, special_mask

    def to_json(self) -> dict:
        return {
            "type": "TemplateProcessing",
            "single": self.single,
            "pair": self.pair,
            "special_tokens": self.special_tokens,
        }


def _pair_template(cls_tok, cls_id, sep_tok, sep_id, roberta: bool):
    """Build TemplateProcessing-equivalent behavior for (Ro)bert(a)Processing."""
    single = [
        {"SpecialToken": {"id": cls_tok, "type_id": 0}},
        {"Sequence": {"id": "A", "type_id": 0}},
        {"SpecialToken": {"id": sep_tok, "type_id": 0}},
    ]
    if roberta:
        pair = single + [
            {"SpecialToken": {"id": sep_tok, "type_id": 0}},
            {"Sequence": {"id": "B", "type_id": 0}},
            {"SpecialToken": {"id": sep_tok, "type_id": 0}},
        ]
    else:
        pair = single + [
            {"Sequence": {"id": "B", "type_id": 1}},
            {"SpecialToken": {"id": sep_tok, "type_id": 1}},
        ]
    specials = {
        cls_tok: {"id": cls_tok, "ids": [cls_id], "tokens": [cls_tok]},
        sep_tok: {"id": sep_tok, "ids": [sep_id], "tokens": [sep_tok]},
    }
    return TemplateProcessing(single, pair, specials)


class RobertaProcessing(PostProcessor):
    def __init__(self, sep, cls, trim_offsets: bool = True, add_prefix_space: bool = True):
        self.sep = tuple(sep)  # (token, id)
        self.cls = tuple(cls)
        self.trim_offsets = trim_offsets
        self.add_prefix_space = add_prefix_space
        self._tmpl = _pair_template(self.cls[0], self.cls[1], self.sep[0], self.sep[1],
                                    roberta=True)

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return 4 if is_pair else 2

    def process(self, ids, tokens, offsets, pair=None, add_special_tokens=True):
        return self._tmpl.process(ids, tokens, offsets, pair, add_special_tokens)

    def to_json(self) -> dict:
        return {
            "type": "RobertaProcessing",
            "sep": list(self.sep),
            "cls": list(self.cls),
            "trim_offsets": self.trim_offsets,
            "add_prefix_space": self.add_prefix_space,
        }


class BertProcessing(PostProcessor):
    def __init__(self, sep, cls):
        self.sep = tuple(sep)
        self.cls = tuple(cls)
        self._tmpl = _pair_template(self.cls[0], self.cls[1], self.sep[0], self.sep[1],
                                    roberta=False)

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return 3 if is_pair else 2

    def process(self, ids, tokens, offsets, pair=None, add_special_tokens=True):
        return self._tmpl.process(ids, tokens, offsets, pair, add_special_tokens)

    def to_json(self) -> dict:
        return {"type": "BertProcessing", "sep": list(self.sep), "cls": list(self.cls)}


class ByteLevelPost(PostProcessor):
    """GPT-2's post-processor only trims offsets; no tokens are added."""

    def __init__(self, trim_offsets: bool = True, add_prefix_space: bool = True):
        self.trim_offsets = trim_offsets
        self.add_prefix_space = add_prefix_space

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return 0

    def process(self, ids, tokens, offsets, pair=None, add_special_tokens=True):
        out_ids, out_tokens, out_offsets = list(ids), list(tokens), list(offsets)
        if pair is not None:
            p_ids, p_tokens, p_offsets = pair
            out_ids += p_ids
            out_tokens += p_tokens
            out_offsets += p_offsets
        if self.trim_offsets:
            def _is_space_char(c):
                # only the byte-level space char and literal whitespace count;
                # tab/newline byte-chars (ĉ/Ċ) are NOT trimmed
                return c == "Ġ" or c.isspace()

            def _trim(i, tok, off):
                s, e = off
                n_lead = 0
                for c in tok:
                    if _is_space_char(c):
                        n_lead += 1
                    else:
                        break
                n_trail = 0
                for c in reversed(tok):
                    if _is_space_char(c):
                        n_trail += 1
                    else:
                        break
                if n_lead > 0:
                    is_first = i == 0 or s == 0
                    if not (is_first and self.add_prefix_space and n_lead == 1):
                        s = min(s + n_lead, e)
                if n_trail > 0 and e >= n_trail:
                    e = max(e - n_trail, s)
                return (s, e)

            out_offsets = [
                _trim(i, t, o) for i, (t, o) in enumerate(zip(out_tokens, out_offsets))
            ]
        type_ids = [0] * len(ids) + ([1] * (len(out_ids) - len(ids)))
        return out_ids, out_tokens, out_offsets, type_ids, [0] * len(out_ids)

    def to_json(self) -> dict:
        return {
            "type": "ByteLevel",
            "add_prefix_space": True,
            "trim_offsets": self.trim_offsets,
            "use_regex": True,
        }


class SequencePost(PostProcessor):
    def __init__(self, processors):
        self.processors = [p for p in processors if p is not None]

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return sum(p.num_special_tokens_to_add(is_pair) for p in self.processors)

    def process(self, ids, tokens, offsets, pair=None, add_special_tokens=True):
        type_ids = [0] * len(ids)
        special_mask = [0] * len(ids)
        for p in self.processors:
            ids, tokens, offsets, type_ids, special_mask = p.process(
                ids, tokens, offsets, pair, add_special_tokens
            )
            pair = None  # consumed by the first processor that uses it
        return ids, tokens, offsets, type_ids, special_mask

    def to_json(self) -> dict:
        return {"type": "Sequence", "processors": [p.to_json() for p in self.processors]}
