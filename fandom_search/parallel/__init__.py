from fandom_search.parallel.mesh import make_mesh  # noqa: F401
from fandom_search.parallel.sharded import (  # noqa: F401
    ShardedSearchEngine,
    sharded_topk,
)
