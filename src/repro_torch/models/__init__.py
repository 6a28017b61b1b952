"""LM models of the port: the ``attn`` and ``mamba2`` blocks, the
transformer assembly with prefill and one-token decode (own copies of
``repro.models``)."""
