"""One module a driver, found by the name in a workload's file."""
