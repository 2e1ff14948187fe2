"""LM substrate of the port: layers, attention, the SSD head and the
decoder assembly (transformer.py) behind the Model facade (model.py), and
the loader of the reference's parameters (convert.py)."""

from .model import Model, build_model
