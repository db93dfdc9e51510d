# Model configurations ported so far (field for field the reference's).
