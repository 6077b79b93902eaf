"""GPT-2 byte <-> unicode-char maps.

Byte-level tokenizers store raw bytes as printable unicode characters so that
vocab files remain valid text. The construction is the standard GPT-2 one:
printable latin bytes map to themselves, everything else is shifted into the
U+0100.. range. Counterpart of ``zett_tpu/tokenization/bytemaps.py``.
"""


def _byte_to_char_map() -> dict:
    # bytes that are kept as-is: '!'..'~', '¡'..'¬', '®'..'ÿ'
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {}
    n = 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + n)
            n += 1
    return mapping


BYTES_TO_CHARS: dict = _byte_to_char_map()
CHARS_TO_BYTES: dict = {c: b for b, c in BYTES_TO_CHARS.items()}

# The 256-char byte alphabet in byte order.
BYTE_ALPHABET = tuple(BYTES_TO_CHARS[b] for b in range(256))

# latin-1 decode is the identity on bytes; one str.translate then maps each
# unit through the table
_B2C_TRANS = str.maketrans(dict(BYTES_TO_CHARS))


def bytes_to_byte_chars(raw: bytes) -> str:
    """Encode raw bytes as the printable byte-char representation."""
    return raw.decode("latin-1").translate(_B2C_TRANS)
