"""Forward-Forward core of the port: primitives, strategies, the MLP."""
