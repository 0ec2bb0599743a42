"""resident_bytes_per_nnz: the bytes of the device streams that the
program's build placed on the card (its counter "upload_bytes", the sum of
``SpmvOperator.device_bytes()``: values, columns, row indices, chunk and
group tables, pieces; lib/program.py) over the matrix's nonzeros. The
benchmark builds one operator in a run's process. None where the program
keeps no such counter."""

from spmv_cells.lib import program


def read(ctx):
    uploaded = program.counter("upload_bytes")
    if not uploaded:
        return None
    return uploaded / ctx.nnz
