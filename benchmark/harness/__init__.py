"""The harness: cells, traffic, trace reduction and the yardstick."""
