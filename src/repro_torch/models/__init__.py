"""Models of the port: the dense LM decoder (config, params, layers, model).

Port of ``src/repro/models``; see ``model.py`` for what is ported so far.
"""
