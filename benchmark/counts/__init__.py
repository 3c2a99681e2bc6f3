"""Work counts from shapes and the published peaks they are held to."""
