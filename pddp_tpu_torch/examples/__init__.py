"""Example problems of the port: cartpole, pendulum, double cartpole and
rendezvous (their envs and ``problems.py`` are not ported yet)."""
