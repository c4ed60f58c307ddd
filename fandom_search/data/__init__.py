from fandom_search.data.tokenizer import tokenize, Tokenized  # noqa: F401
from fandom_search.data.hashing import (  # noqa: F401
    fmix32,
    hash_word,
    hash_words,
    derive_sign_mults,
)
from fandom_search.data.shingler import (  # noqa: F401
    shingle_hashes,
    embed_shingles_np,
    embed_shingles,
)
from fandom_search.data.script_parser import parse_script, ScriptLine  # noqa: F401
