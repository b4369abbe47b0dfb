"""The language-model stack of the port: the dense decoder-only family
(``transformer``), its layers and GQA attention over the hand-written
``flash_attention`` (prefill) and ``decode_attention`` (decode) kernels;
the ssm family (Mamba2, ``ssm``) over the hand-written ``ssd_scan``
kernel (prefill) and the plain ``ssd_step`` (decode); and the ``Model``
API (``model.build_model``) that ``serve.ServeEngine`` drives."""
