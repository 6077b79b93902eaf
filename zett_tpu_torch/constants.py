"""Constants of the port (counterpart of ``zett_tpu/constants.py``)."""

# Fill value used to mask out logits / priors ("-inf" that is safe in bf16 sums).
NEGATIVE_INF_FILL_VALUE = -100_000

# Upper bound on characters a single token can cover; bounds the text span
# fed to the tokenizer sampler.
MAX_CHARS_PER_TOKEN = 16

EPSILON = 1e-8

# Score penalty below the vocab's minimum for a Unigram lattice's unknown
# character (sentencepiece's kUnkPenalty).
UNK_PENALTY = 10.0

# The GPT-2-style pre-tokenization patterns installed on converted and
# sampled tokenizers. Kept as strings only: the port never compiles them (the
# native host library's scanner implements both, zett_host.cpp).
SPLIT_REGEX = r"'s|'t|'re|'ve|'m|'ll|'d| ?[\p{L}\p{M}]+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
SPLIT_REGEX_NO_MARKS = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

# Characters that byte-level encodings use for whitespace bytes we care about:
# space (0x20) -> "Ġ", newline (0x0A) -> "Ċ", tab (0x09) -> "ĉ".
EXTRA_WHITESPACE_CHARS = ("Ġ", "Ċ", "ĉ")
