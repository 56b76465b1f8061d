"""Stream engine of the port: lowering, seed-batched tick, sweep driver."""
