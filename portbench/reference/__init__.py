"""The plain reference: PyTorch and NumPy only, with its own frozen copies of
the codes' tables, the GF(2) encoder, the layered min-sum, the bit-flip
decoder and the waterfall's seeding rule. It imports nothing of the
program."""
