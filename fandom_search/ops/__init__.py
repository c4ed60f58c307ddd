from fandom_search.ops.distance_topk import (  # noqa: F401
    topk_dot_jnp,
    topk_dot_triton,
    topk_dot,
)
