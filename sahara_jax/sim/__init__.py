from sahara_jax.sim.read_simulator import Transcript, simulate_reads
