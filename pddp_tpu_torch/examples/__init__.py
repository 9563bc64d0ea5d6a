"""Example problems of the port: cartpole, pendulum, double cartpole and
rendezvous, each with its model, cost and env, and the registry of them
(``problems.SampleProblems``)."""
