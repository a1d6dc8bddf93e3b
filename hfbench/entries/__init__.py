"""Program entries: how a cell's steps call the port, what work a step
needs, and the plain reference of one step."""
