from .netcdf3 import write_netcdf, read_netcdf, NetCDFData
