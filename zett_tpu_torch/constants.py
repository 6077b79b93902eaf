"""Constants of the transfer path (counterpart of ``zett_tpu/constants.py``)."""

# Fill value used to mask out logits / priors ("-inf" that is safe in bf16 sums).
NEGATIVE_INF_FILL_VALUE = -100_000

# The GPT-2-style pre-tokenization pattern installed on converted tokenizers.
# Kept as a string only: the port never compiles it (transfer encodes no text).
SPLIT_REGEX = r"'s|'t|'re|'ve|'m|'ll|'d| ?[\p{L}\p{M}]+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

# Characters that byte-level encodings use for whitespace bytes we care about:
# space (0x20) -> "Ġ", newline (0x0A) -> "Ċ", tab (0x09) -> "ĉ".
EXTRA_WHITESPACE_CHARS = ("Ġ", "Ċ", "ĉ")
