"""Models of the port: the dense LM decoder (config, params, layers, model).

Port of ``src/repro/models`` for the dense GQA family: the forward for
training (``forward_train``, ``loss_fn`` and its backward by autograd under
``cfg.remat``), prefill and decode; see ``model.py`` for the families that
are not ported yet.
"""
