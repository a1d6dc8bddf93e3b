"""Plain PyTorch references: the models' forwards and losses and a frozen
Hessian-free step.  Nothing here imports the program under test."""
