"""PyTorch/CUDA port of the Forward-Forward reproduction (``repro``).

The JAX package ``repro`` is the reference and stays as it is; this
package grows beside it, one slice at a time, and imports neither JAX
nor any module of ``repro``. Three slices so far:

* serving the paper's FF MLP: ``repro_torch.api.serve`` ->
  ``serve.engine`` -> ``serve.replica`` -> ``core.ff_mlp.class_scores``
  -> ``kernels.ops.ff_dense``, whose CUDA kernel is hand-written for
  Hopper (``kernels/csrc/ff_dense.cu``);
* training it: ``repro_torch.api.fit`` -> ``core.pff.run_chapter_schedule``
  -> ``core.ff_mlp.train_layer_chapter`` -> ``torch.autograd.grad``
  through ``kernels.ops.ff_dense`` -> ``kernels.ff_dense_vjp.FFDense``,
  whose backward is the hand-written ``kernels/csrc/ff_dense_bwd.cu``;
* serving the LM configs ``qwen2-0.5b`` and ``mamba2-780m``:
  ``repro_torch.launch.serve.lm_decode`` -> ``models.transformer.prefill``
  -> ``models.blocks.block_prefill`` -> ``kernels.ops.flash_attention`` /
  ``kernels.ops.mamba2_ssd`` (hand-written ``kernels/csrc/
  flash_attention.cu`` and ``mamba2_ssd.cu``), then greedy
  ``transformer.serve_step`` decode in plain torch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Parameters are plain dicts of tensors in the reference's layout
(``{"layers": [{"w": (K, N), "b": (N,)}, ...], "head": ...,
"local_heads": [...]}`` for the MLP; ``{"embed", "final_norm", "groups":
(stacked per-layer trees, ...)}`` for an LM).
"""
from repro_torch.device import resolve_device                  # noqa: F401
