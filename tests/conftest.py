"""Test configuration: force the CPU backend with a virtual 8-device
mesh so sharding tests run anywhere, before jax initializes.  The
platform is set through jax.config as well as JAX_PLATFORMS, so the
setting holds even if jax was imported first."""
import os

os.environ['JAX_PLATFORMS'] = 'cpu'
# persistent XLA compilation cache: recompiling the traversal/propagate
# while-loops dominates test wall-clock on small hosts.  These env vars
# are only read at `import jax` time, so they MUST be set before the
# import — set after it, the cache dir stays empty and every session
# recompiles from scratch; the jax.config.update calls below make the
# setting robust even if jax was imported earlier.
os.environ.setdefault('JAX_COMPILATION_CACHE_DIR',
                      '/tmp/chroma_jax_jax_cache')
os.environ.setdefault('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', '1')
import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 8)
jax.config.update('jax_compilation_cache_dir',
                  os.environ['JAX_COMPILATION_CACHE_DIR'])
jax.config.update('jax_persistent_cache_min_compile_time_secs',
                  float(os.environ[
                      'JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS']))
# keep test caches out of the user's real cache
os.environ.setdefault('CHROMA_JAX_CACHE', '/tmp/chroma_jax_test_cache')

# SERVICE_EVERY (walker iterations per physics pass) is a throughput
# knob, not semantics; the tests pin the value their statistics were
# written against.
os.environ.setdefault('CHROMA_JAX_SERVICE_EVERY', '10')
