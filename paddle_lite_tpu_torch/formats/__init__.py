"""Model formats — analog of ``lite/model_parser``.

- ``fluid`` / ``fluid_convert``: the reference's primary input format
  (``__model__`` protobuf + params; ``LoadModelPb``), parsed with no
  protobuf dependency (``protowire``) and converted NCHW→NHWC;
- ``artifact``: the optimized-program container (the ``.nb`` analog,
  written by ``native/nbf.cc``), one file format for both packages;
- ``importer``: torch state_dict / name→array structural weight import;
- ``interop``: graphs carried across from the JAX package in memory.
"""

from .fluid_convert import fluid_to_graph, load_fluid_model  # noqa: F401
