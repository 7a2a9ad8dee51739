"""Data- and tensor-parallel placement over a device mesh of processes."""
