"""Example problems of the port: cartpole, pendulum, double cartpole and
rendezvous, each with its model, cost and env (``problems.py`` is not
ported yet)."""
