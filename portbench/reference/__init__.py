"""Plain answers that decide ``correct``: plain PyTorch on the inputs the
benchmark made, in blocks of rows.  Imports nothing of the port."""
