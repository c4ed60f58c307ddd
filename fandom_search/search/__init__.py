from fandom_search.search.index import ScriptIndex, build_script_index  # noqa: F401
from fandom_search.search.types import MatchRow, CandidateHit  # noqa: F401
from fandom_search.search.chain import chain_hits  # noqa: F401
