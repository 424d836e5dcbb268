"""The step counter the JAX reference's train loops in the tests start
from."""
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec


def first_step(rt):
    """Step 0 as the reference's train step returns its counter: an int32
    replicated over ``rt``'s mesh.  From a bare ``jnp.int32(0)``, which
    has no sharding, the step's second call (with the counter the first
    returned) traces and compiles the step again: about half the CPU
    seconds of a five-step reference stream.  The values are the same
    bits either way."""
    return jax.device_put(jnp.int32(0),
                          NamedSharding(rt.mesh, PartitionSpec()))


def placed_cache(rt, cache, batch: int):
    """The reference's empty ``cache`` placed as its serve steps return
    it (``rt.cache_pspec`` over ``rt``'s mesh): from the unplaced arrays
    of ``init_cache`` the decode step's second call compiles it again."""
    return jax.tree.map(
        lambda a, spec: jax.device_put(a, NamedSharding(rt.mesh, spec)),
        cache, rt.cache_pspec(cache, batch))
