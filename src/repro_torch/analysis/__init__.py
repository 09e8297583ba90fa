"""Cost accounting of the port (the counterpart of ``repro.analysis``):
``cost`` counts FLOPs, bytes, collectives and memory of a torch program as
it runs; ``roofline`` turns a count into time terms with the H100's
constants."""
