"""Host-side core: machine model, context classification, depth solver,
autotune feedback, kernel declarations and the substrate error taxonomy."""
