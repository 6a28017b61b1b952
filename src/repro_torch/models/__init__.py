"""LM models of the port: the ``attn``, ``local_attn``, ``mamba2`` and
``rglru`` blocks, the transformer assembly with prefill and one-token
decode (own copies of ``repro.models``)."""
