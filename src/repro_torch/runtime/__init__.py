"""The training runtime: step builders, the train loop and its fault
tolerance (`runtime.steps`, `runtime.train_loop`,
`runtime.fault_tolerance`)."""
