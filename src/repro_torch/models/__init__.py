"""The language-model stack of the port: the dense decoder-only family
(``transformer``), its layers and GQA attention over the hand-written
``flash_attention`` (prefill) and ``decode_attention`` (decode) kernels,
and the ``Model`` API (``model.build_model``) that ``serve.ServeEngine``
drives."""
