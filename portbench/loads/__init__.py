"""The general generators: one module per kind of traffic (`train`), each
driving the program from a mix's data file (`traffic/<mix>.json`) and
returning a `harness.Run`."""
