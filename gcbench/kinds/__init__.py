"""The loops that drive a cell, one module a traffic file's ``kind``:
``gcbench/kinds/<kind>.py`` with its ``run``."""

import importlib


def kind(name: str):
    """The module of loop ``name``."""
    return importlib.import_module(f"gcbench.kinds.{name}")
