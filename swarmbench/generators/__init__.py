"""Traffic generators: each makes the clients' data of a cell from the
seed and the parameters in the cell's ``traffic`` file, on the device,
and returns it as the per-client dicts the program's entry takes."""
