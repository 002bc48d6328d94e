"""The EigenTrust dynamic set (host, exact), copied from the reference
package: the oracle of ``ops.fieldops.field_converge``."""
