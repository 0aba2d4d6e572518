"""Distributed layer on torch.distributed: exchange, sort, select, scan."""
