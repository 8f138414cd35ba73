"""The JAX reference's LM init with its random re-draw pinned.

``repro.models.transformer.init_params`` re-draws the stacked unit leaves
from ``PRNGKey(hash(cfg.name) % 2**31)``. Python salts ``hash(str)`` per
process, so two runs of one test would hold the port against two different
models. ``reference_init`` gives that module a ``hash`` of its own for the
call: the name's CRC-32, or a stated ``draw``. The parameters then depend
only on what the test states. The reference's file is not edited.
"""
import zlib


def name_hash(name: str) -> int:
    """A stand-in for ``hash`` that no process salts: the CRC-32."""
    return zlib.crc32(name.encode())


def reference_init(tf, jcfg, key, draw=None, init=None):
    """``tf.init_params(jcfg, key)`` (``tf`` the reference's transformer
    module; ``init`` another entry point that reaches it) with the unit
    re-draw keyed by ``draw`` (the value the salted ``hash(cfg.name) %
    2**31`` would take) or, by default, the name's CRC-32."""
    tf.hash = name_hash if draw is None else (lambda _name: draw)
    try:
        return (init or tf.init_params)(jcfg, key)
    finally:
        del tf.hash
