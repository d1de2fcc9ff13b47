"""Event IO (parity: chroma/io).

Formats:
  * chroma_jax.io.npz  — self-contained numpy event files (always
    available; the native format of this framework)
  * chroma_jax.io.root — ROOT event files (requires a ROOT install,
    like the reference's chroma/io/root.py)
  * chroma_jax.io.ntuple — flat uproot/awkward ntuples (requires
    uproot, like the reference's chroma/io/ntuple.py)
"""
