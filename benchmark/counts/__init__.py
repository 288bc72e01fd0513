"""The benchmark's work counts, from shapes and from the frozen reference,
never from the port: the bytes of a segment sum (`segment_sum.py`), the
bytes and operations of a cloth solve (`cloth_solve.py`), and the matrix
products of a control step and a minibatch step (`flops.py`)."""
