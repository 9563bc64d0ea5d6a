"""Example problems of the port: cartpole so far (ROADMAP A8 adds the rest)."""
