"""The harness's own modules: names and files, the program driven through a
cell's window, the trace, the work arithmetic and the plain reference."""
