"""Framework-wide logger (parity: chroma/log.py)."""
import logging

logger = logging.getLogger('chroma_jax')
logger.addHandler(logging.NullHandler())
