"""Decoders: token strings -> text, JSON-compatible with HF tokenizers
(counterpart of ``zett_tpu/tokenization/decoders.py``): ByteLevel (GPT-2
family), Metaspace (sentencepiece family), ByteFallback, Fuse, Replace and
Strip (the Llama family's sequence), WordPiece (BERT), BPEDecoder and
Sequence; CTC loads as Fuse, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional

from .bytemaps import CHARS_TO_BYTES


class Decoder:
    def decode_chain(self, tokens: List[str]) -> List[str]:
        raise NotImplementedError

    def decode(self, tokens: List[str]) -> str:
        return "".join(self.decode_chain(tokens))

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(data: Optional[dict]) -> Optional["Decoder"]:
        if data is None:
            return None
        t = data["type"]
        if t == "ByteLevel":
            return ByteLevel()
        if t == "Metaspace":
            return Metaspace(
                replacement=data.get("replacement", "▁"),
                prepend_scheme=data.get("prepend_scheme", "always"),
                split=data.get("split", True),
            )
        if t == "WordPiece":
            return WordPieceDecoder(
                prefix=data.get("prefix", "##"), cleanup=data.get("cleanup", True)
            )
        if t == "ByteFallback":
            return ByteFallback()
        if t == "Fuse":
            return Fuse()
        if t == "Replace":
            return ReplaceDecoder(data["pattern"], data["content"])
        if t == "Strip":
            return StripDecoder(
                content=data.get("content", " "),
                start=data.get("start", 0),
                stop=data.get("stop", 0),
            )
        if t == "Sequence":
            return Sequence([Decoder.from_json(d) for d in data["decoders"]])
        if t == "BPEDecoder":
            return BPEDecoder(suffix=data.get("suffix", "</w>"))
        if t == "CTC":  # not used by zett; accept and pass through
            return Fuse()
        raise ValueError(f"Unsupported decoder type: {t}")


class ByteLevel(Decoder):
    def decode_chain(self, tokens: List[str]) -> List[str]:
        # decode the CONCATENATED byte stream (multi-byte utf-8 sequences may
        # span token boundaries); chars outside the byte alphabet (special
        # tokens) pass through as segment separators
        out: List[str] = []
        pending = bytearray()

        def flush():
            if pending:
                out.append(pending.decode("utf-8", errors="replace"))
                pending.clear()

        for tok in tokens:
            if all(c in CHARS_TO_BYTES for c in tok):
                pending.extend(CHARS_TO_BYTES[c] for c in tok)
            else:
                flush()
                out.append(tok)
        flush()
        return out

    def to_json(self) -> dict:
        return {
            "type": "ByteLevel",
            "add_prefix_space": True,
            "trim_offsets": True,
            "use_regex": True,
        }


class Metaspace(Decoder):
    def __init__(self, replacement: str = "▁", prepend_scheme: str = "always", split: bool = True):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for i, tok in enumerate(tokens):
            s = tok.replace(self.replacement, " ")
            if i == 0 and self.prepend_scheme != "never" and s.startswith(" "):
                s = s[1:]
            out.append(s)
        return out

    def to_json(self) -> dict:
        return {
            "type": "Metaspace",
            "replacement": self.replacement,
            "prepend_scheme": self.prepend_scheme,
            "split": self.split,
        }


class WordPieceDecoder(Decoder):
    def __init__(self, prefix: str = "##", cleanup: bool = True):
        self.prefix = prefix
        self.cleanup = cleanup

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for i, tok in enumerate(tokens):
            if i != 0:
                if tok.startswith(self.prefix):
                    tok = tok[len(self.prefix):]
                else:
                    tok = " " + tok
            if self.cleanup:
                for a, b in ((" .", "."), (" ,", ","), (" !", "!"), (" ?", "?"),
                             (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                             (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                    tok = tok.replace(a, b)
            out.append(tok)
        return out

    def to_json(self) -> dict:
        return {"type": "WordPiece", "prefix": self.prefix, "cleanup": self.cleanup}


class ByteFallback(Decoder):
    """Collapse runs of <0xAB> byte tokens into decoded utf-8."""

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out: List[str] = []
        pending: bytearray = bytearray()

        def flush():
            if pending:
                out.append(pending.decode("utf-8", errors="replace"))
                pending.clear()

        for tok in tokens:
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                try:
                    pending.append(int(tok[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(tok)
        flush()
        return out

    def to_json(self) -> dict:
        return {"type": "ByteFallback"}


class Fuse(Decoder):
    def decode_chain(self, tokens: List[str]) -> List[str]:
        return ["".join(tokens)]

    def to_json(self) -> dict:
        return {"type": "Fuse"}


class ReplaceDecoder(Decoder):
    def __init__(self, pattern, content: str):
        self.pattern = pattern
        self.content = content
        self._lit = pattern["String"] if isinstance(pattern, dict) else pattern

    def decode_chain(self, tokens: List[str]) -> List[str]:
        return [t.replace(self._lit, self.content) for t in tokens]

    def to_json(self) -> dict:
        pattern = self.pattern if isinstance(self.pattern, dict) else {"String": self.pattern}
        return {"type": "Replace", "pattern": pattern, "content": self.content}


class StripDecoder(Decoder):
    def __init__(self, content: str = " ", start: int = 0, stop: int = 0):
        self.content = content
        self.start = start
        self.stop = stop

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for tok in tokens:
            i = 0
            while i < self.start and tok.startswith(self.content):
                tok = tok[len(self.content):]
                i += 1
            i = 0
            while i < self.stop and tok.endswith(self.content):
                tok = tok[: -len(self.content)]
                i += 1
            out.append(tok)
        return out

    def to_json(self) -> dict:
        return {"type": "Strip", "content": self.content, "start": self.start, "stop": self.stop}


class BPEDecoder(Decoder):
    def __init__(self, suffix: str = "</w>"):
        self.suffix = suffix

    def decode_chain(self, tokens: List[str]) -> List[str]:
        n = len(tokens)
        return [
            t.replace(self.suffix, " " if i != n - 1 else "")
            for i, t in enumerate(tokens)
        ]

    def to_json(self) -> dict:
        return {"type": "BPEDecoder", "suffix": self.suffix}


class Sequence(Decoder):
    def __init__(self, decoders):
        self.decoders = [d for d in decoders if d is not None]

    def decode_chain(self, tokens: List[str]) -> List[str]:
        for d in self.decoders:
            tokens = d.decode_chain(tokens)
        return tokens

    def to_json(self) -> dict:
        return {"type": "Sequence", "decoders": [d.to_json() for d in self.decoders]}
