"""Fleet-scale workload machinery of the port.  So far only the arrival
processes of the reference's ``repro.fleet.traces`` (what the wall-clock
runtime's ``ArrivalSchedule`` draws from); the rest of the reference's
``fleet/`` comes with the sim and fleet slice (ROADMAP A.12)."""
