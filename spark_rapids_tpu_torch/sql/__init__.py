"""SQL front end (types, expressions, logical plans, parser, planner,
DataFrame, session) copied from the JAX package for the port."""
