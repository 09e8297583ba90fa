"""Model configurations of the port: a copy of ``repro.configs``
(``ModelConfig``, ``ShapeConfig``, the ten architectures) with its imports
retargeted, so that ``get_config(name)`` resolves every name the
reference does."""
