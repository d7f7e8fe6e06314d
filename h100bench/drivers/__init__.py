"""One module per entry of the program that a cell drives. Each has
`run(run: harness.Run) -> harness.Outcome`."""
