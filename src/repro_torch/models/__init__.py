"""Models of the port: the LM substrate (config, params, layers, moe,
ssm, model).

Port of ``src/repro/models`` for every family: dense (GQA or MLA), moe,
ssm, hybrid, vlm and the audio encoder; the forward for training
(``forward_train``, ``loss_fn`` and its backward by autograd under
``cfg.remat``), prefill and decode.
"""
