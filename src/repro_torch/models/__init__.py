"""The language-model stack of the port: the dense decoder-only family
(``transformer``), its layers and GQA attention over the hand-written
``flash_attention`` (prefill) and ``decode_attention`` (decode) kernels;
the moe family, whose MLPs are mixture-of-experts blocks (``moe``:
top-k routing, capacity-bounded dispatch, plain batched matmuls over
the experts); the ssm family (Mamba2, ``ssm``) over the hand-written
``ssd_scan`` kernel (prefill) and the plain ``ssd_step`` (decode); the
hybrid family (Zamba2); and the ``Model`` API (``model.build_model``)
that ``serve.ServeEngine`` drives."""
