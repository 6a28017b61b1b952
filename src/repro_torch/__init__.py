"""PyTorch/CUDA port of the Forward-Forward reproduction (``repro``).

The JAX package ``repro`` is the reference and stays as it is; this
package grows beside it, one slice at a time, and imports neither JAX
nor any module of ``repro``. The first slice serves the paper's FF MLP:
``repro_torch.api.serve`` -> ``serve.engine`` -> ``serve.replica`` ->
``core.ff_mlp.class_scores`` -> ``kernels.ops.ff_dense``, whose CUDA
kernel is hand-written for Hopper (``kernels/csrc/ff_dense.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Parameters are plain dicts of tensors in the reference's layout
(``{"layers": [{"w": (K, N), "b": (N,)}, ...], "head": ...,
"local_heads": [...]}``).
"""
from repro_torch.device import resolve_device                  # noqa: F401
